"""Monte-Carlo engine (one device; the multi-GPU engine is not ported yet)."""
from .montecarlo import MonteCarloResult, make_round_fn, montecarlo_ber

__all__ = ["MonteCarloResult", "make_round_fn", "montecarlo_ber"]
