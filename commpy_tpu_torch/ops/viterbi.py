"""Batched Viterbi decoding.

Counterpart of ``commpy_tpu/ops/viterbi.py`` (reference
commpy/channelcoding/convcode.py:590-749), with its conventions:

* **Branch metrics** are a dot product of the received word with one
  vector per branch; the three reference metrics differ from it only by a
  per-step constant and a positive scale, which leave every comparison
  unchanged:

  * hard:        Hamming = const_t + ob . (1 - 2 r)  (plus a per-branch sum)
  * soft:        sum(ob ? nLL1 : nLL0) = const_t - ob . clip(r, +-500)
  * unquantized: ||r - (2 ob - 1)||^2 = const_t + n - 2 r . (2 ob - 1)

* **ACS** takes branch j over the running best only when strictly
  smaller (ties keep the lower branch), the best state is the first-index
  argmin, and path metrics are renormalised by their per-step minimum.
* **Windowed traceback**: message symbol m is finalised by the traceback
  that starts at ``min(m + tb_depth - 1, T)`` after the corresponding
  number of back-steps, which every position walks independently here.

Two paths, chosen by the trellis as the JAX package chooses:

* binary-input, shift-structured trellises (the j-th predecessor of s is
  ``((s & (S/2-1)) << 1) | j`` and the input bit entering s is its MSB,
  every feedforward k=1 code) within the kernels' limits (``acs_plan``:
  S <= 1024, n <= 8) go to the ACS and traceback kernels of
  ``kernels/viterbi_acs.py``: the CUDA kernels for a CUDA tensor, their
  plain PyTorch versions for a CPU tensor;
* every other trellis (k > 1, recursive codes whose input bit is not the
  state MSB, and shift-structured ones past the kernels' limits) runs
  the general table-driven path in plain PyTorch, as the JAX package
  runs its XLA scan.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.viterbi_acs import (MAX_N, MAX_STATES, UNREACHED, acs_forward,
                                   acs_forward_plain, acs_plan, traceback,
                                   traceback_plain)
from ..utils.bits import unpack_bits
from ..utils.device import device_constant, on_device
from .trellis import Trellis

__all__ = ["viterbi_decode", "viterbi_decode_device", "make_viterbi_decoder",
           "received_words"]

_LLR_CLIP = 500.0  # reference convcode.py:718-719
_BACKENDS = ("auto", "cuda", "torch")


def _branch_vectors(trellis: Trellis, decoding_type: str) -> np.ndarray:
    """[S*I, n] vectors c such that bm = r . c (+ per-step constant)."""
    ob = trellis.branch_codewords.reshape(-1, trellis.n).astype(np.float32)
    if decoding_type == "hard":
        return 1.0 - 2.0 * ob
    elif decoding_type == "soft":
        return -ob
    elif decoding_type == "unquantized":
        return -(2.0 * ob - 1.0)
    raise ValueError(
        'The available decoding types are "hard", "soft" and "unquantized"'
    )


def _hard_const(trellis: Trellis) -> np.ndarray:
    """Per-branch sum(ob) of the hard metric [S*I] (not a per-step constant,
    so it is kept)."""
    return trellis.branch_codewords.reshape(-1, trellis.n).sum(-1).astype(
        np.float32)


def _is_shift_structured(trellis: Trellis) -> bool:
    """True iff k == 1, pred_state[s, j] == ((s & (S/2-1)) << 1) | j and
    pred_input[s, j] == s >> (log2(S) - 1): the closed forms both kernels
    use.  Recursive codes have the first property but not the second."""
    if trellis.k != 1:
        return False
    S = trellis.number_states
    s = np.arange(S)
    pred = ((s & (S // 2 - 1))[:, None] << 1) | np.arange(2)[None, :]
    msb = (s >> max(S.bit_length() - 2, 0))[:, None]
    return bool(np.array_equal(trellis.pred_state_table, pred)
                and np.all(trellis.pred_input_table == msb))


def _branch_metrics(r: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[B, T, n] x [c, n] -> [B, T, c], summed over n in index order."""
    bm = r[..., 0:1] * C[:, 0]
    for i in range(1, r.shape[-1]):
        bm = bm + r[..., i:i + 1] * C[:, i]
    return bm


def _viterbi_core(bm: torch.Tensor, pred_state: torch.Tensor):
    """General ACS over ``bm [B, T, S, I]``; returns (chosen branch index
    ``[B, T, S]``, best state ``[B, T]``)."""
    B, T, S, I = bm.shape
    dev = bm.device
    pm = torch.full((B, S), UNREACHED, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    dec = torch.empty((B, T, S), dtype=torch.long, device=dev)
    best = torch.empty((B, T), dtype=torch.long, device=dev)
    for t in range(T):
        cand = pm[:, pred_state] + bm[:, t]  # [B, S, I]
        new = cand[..., 0]
        j_star = torch.zeros((B, S), dtype=torch.long, device=dev)
        for j in range(1, I):  # running min, first-index tie-break
            take = cand[..., j] < new
            new = torch.where(take, cand[..., j], new)
            j_star = torch.where(take, j, j_star)
        dec[:, t] = j_star
        best[:, t] = torch.argmin(new, dim=1)
        pm = new - torch.amin(new, dim=1, keepdim=True)
    return dec, best


def _traceback_windows(dec, best, pred_state, pred_input, k: int,
                       tb_depth: int) -> torch.Tensor:
    """Table-driven sliding-window traceback; returns bits ``[B, T*k]``."""
    B, T, S = dec.shape
    dev = dec.device
    p = torch.arange(T, device=dev)
    w = torch.clamp(p + (tb_depth - 2), max=T - 1)
    steps = w - p
    cur = best[:, w]
    bidx = torch.arange(B, device=dev)[:, None]
    for i in range(min(tb_depth - 2, T - 1)):
        t = torch.clamp(w - i, min=0)[None, :]
        j = dec[bidx, t, cur]
        cur = torch.where(i < steps, pred_state[cur, j], cur)
    j = dec[bidx, p[None, :], cur]
    return unpack_bits(pred_input[cur, j], k).reshape(B, T * k)


def _kernels_take(trellis: Trellis) -> bool:
    """Whether K1 and K2 take this trellis: shift-structured, with a
    number of states and a codeword width that ``acs_plan`` accepts."""
    if not _is_shift_structured(trellis):
        return False
    try:
        acs_plan(trellis.number_states, trellis.n, 1)
    except ValueError:
        return False
    return True


def viterbi_route(trellis: Trellis, backend: str, device_type: str) -> str:
    """The decoder's route for ``trellis`` on a tensor of ``device_type``.

    ``'kernels'``: K1 and K2 (the CUDA kernels on ``'cuda'``, their plain
    versions on the CPU); ``'plain'``: the kernels' plain versions on any
    device; ``'general'``: the table-driven path that takes any trellis.
    ``backend='auto'`` takes the kernels for every trellis they take and
    the general path for the rest; ``'cuda'`` raises unless the tensor is
    on the card and the kernels take the trellis; ``'torch'`` takes the
    plain versions for a shift-structured trellis, else the general path.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda":
        if device_type != "cuda":
            raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                             f"{device_type}")
        if not _kernels_take(trellis):
            raise NotImplementedError(
                "backend='cuda' takes binary shift-structured trellises of "
                f"at most {MAX_STATES} states and {MAX_N} outputs (got "
                f"{trellis.number_states} states, n = {trellis.n}, shift-"
                f"structured: {_is_shift_structured(trellis)}); use "
                "backend='auto'")
        return "kernels"
    if backend == "torch":
        return "plain" if _is_shift_structured(trellis) else "general"
    return "kernels" if _kernels_take(trellis) else "general"


def viterbi_decode_device(coded_bits, trellis: Trellis, tb_depth=None,
                          decoding_type="hard", L=None, backend="auto",
                          exact: bool = False, fuse_bm=None, device="cuda"):
    """Batched Viterbi decode on ``device``.

    Parameters
    ----------
    coded_bits : ``[..., n_coded]`` tensor or array (hard bits, LLRs or
        +-1 reals by ``decoding_type``), moved to ``device``.
    trellis : Trellis
    tb_depth : traceback depth (default ``min(5 * total_memory, L)``, >= 2)
    L : number of message bits to return (default ``n_coded * k / n``)
    backend : ``'auto'`` sends shift-structured binary trellises of at
        most S = 1024 states and n = 8 outputs to the ACS and traceback
        kernels (the CUDA kernels on the card, their plain versions on the
        CPU) and every other trellis to the general path; ``'cuda'``
        requires the CUDA kernels and raises on the CPU or for a trellis
        they do not take; ``'torch'`` uses plain PyTorch on any device
        (:func:`viterbi_route`).
    exact, fuse_bm : accepted for parity with the JAX package and ignored.
        They chose TPU matrix-unit precision and kernel fusion; float32
        arithmetic on the CUDA cores is already exact, so there is nothing
        for them to buy.
    device : where to decode (default the card); ``'cpu'`` decodes on the
        host.

    Returns
    -------
    decoded_bits : int8 ``[..., L]`` on ``device``
    """
    x = on_device(coded_bits, device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    x = x.reshape((-1,) + x.shape[-1:])
    B = x.shape[0]
    dev = x.device

    k, n = trellis.k, trellis.n
    tm = trellis.total_memory
    if L is None:
        L = int(x.shape[-1] * k / n)
    if tb_depth is None:
        tb_depth = min(5 * tm, L)
    tb_depth = int(tb_depth)
    if tb_depth < 2:
        # the traceback emits at back-step depth tb_depth-2; a 1-deep
        # window would silently return zeros
        raise ValueError(f"tb_depth must be >= 2 (got {tb_depth})")
    C_np = _branch_vectors(trellis, decoding_type)  # [S*I, n]
    r = received_words(x, trellis, decoding_type, L)
    T = r.shape[1]

    S, I = trellis.number_states, trellis.number_inputs
    route = viterbi_route(trellis, backend, dev.type)
    if route == "plain":
        C, hc = _kernel_tables(C_np, trellis, decoding_type, dev)
        dec, best = acs_forward_plain(r, C, hc)
        bits = traceback_plain(dec, best, S, tb_depth)
    elif route == "kernels":
        C, hc = _kernel_tables(C_np, trellis, decoding_type, dev)
        dec, best = acs_forward(r, C, hc)
        bits = traceback(dec, best, S, tb_depth)
    else:
        C = device_constant(C_np, dev)
        bm = _branch_metrics(r, C)  # [B, T, S*I], branch axis flat (s, j)
        if decoding_type == "hard":
            bm = bm + device_constant(_hard_const(trellis), dev)
        bm = bm.reshape(B, T, S, I)
        ps = device_constant(trellis.pred_state_table.astype(np.int64), dev)
        pu = device_constant(trellis.pred_input_table.astype(np.int64), dev)
        dec, best = _viterbi_core(bm, ps)
        bits = _traceback_windows(dec, best, ps, pu, k, tb_depth)
    bits = bits[:, :L].to(torch.int8).reshape(lead + (L,))
    if squeeze:
        bits = bits[0]
    return bits


def received_words(x: torch.Tensor, trellis: Trellis, decoding_type: str,
                   L: int) -> torch.Tensor:
    """``[B, n_coded]`` -> the decoder's input ``r [B, T, n]`` float32.

    T = (L+tm)//k - 1 ACS steps consume codewords 0..T-1, padded with 0
    (-1 for unquantized) past the received ones (convcode.py:721-732);
    soft LLRs are clipped to +-500.
    """
    B, n = x.shape[0], trellis.n
    T = (L + trellis.total_memory) // trellis.k - 1
    n_cw = x.shape[-1] // n
    r = x.to(torch.float32)
    if decoding_type == "soft":
        r = torch.clamp(r, -_LLR_CLIP, _LLR_CLIP)
    r = r[:, : n_cw * n].reshape(B, n_cw, n)
    if T > n_cw:
        pad_val = -1.0 if decoding_type == "unquantized" else 0.0
        pad = torch.full((B, T - n_cw, n), pad_val, dtype=torch.float32,
                         device=x.device)
        r = torch.cat([r, pad], dim=1)
    return r[:, :T].contiguous()


def _kernel_tables(C_np, trellis, decoding_type, dev):
    """Branch vectors ``[2, S, n]`` and hard constants ``[2, S]`` (or None)
    in the kernels' branch-major layout."""
    S, n = trellis.number_states, trellis.n
    C = device_constant(C_np.reshape(S, 2, n).transpose(1, 0, 2), dev)
    hc = None
    if decoding_type == "hard":
        hc = device_constant(_hard_const(trellis).reshape(S, 2).T, dev)
    return C, hc


def viterbi_decode(coded_bits, trellis: Trellis, tb_depth=None,
                   decoding_type="hard", device="cuda") -> np.ndarray:
    """Reference-compatible single-stream wrapper (convcode.py:661-749):
    decodes on ``device`` and returns a NumPy int array."""
    out = viterbi_decode_device(
        np.asarray(coded_bits, dtype=float), trellis, tb_depth, decoding_type,
        device=device)
    return out.cpu().numpy().astype(int)


def make_viterbi_decoder(trellis: Trellis, tb_depth: int, decoding_type: str,
                         L: int, device="cuda"):
    """Return a closure decoding fixed-shape batches on ``device``."""

    def decode(coded_bits):
        return viterbi_decode_device(
            coded_bits, trellis, tb_depth, decoding_type, L=L, device=device
        )

    return decode
