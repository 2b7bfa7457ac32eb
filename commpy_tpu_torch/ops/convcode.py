"""Convolutional encoding and puncturing.

Counterpart of ``commpy_tpu/ops/convcode.py``.  ``encode_scan`` encodes a
batch ``[..., L]`` on the tensor's device: feedforward codes as shifted
XORs of the input (no sequential loop), other codes by clocking the
trellis FSM in a Python loop over time, eight input bits a step.  :func:`conv_encode` is the
reference-compatible host encoder ('cont' / 'term' framing, the RSC tail
driven by the reversed state bits, and the historical full-length
punctured output).  Puncturing is a static mask; depuncturing is a
gather through a static source index followed by a ``where``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.bits import np_pack_bits, np_unpack_bits, pack_bits, unpack_bits
from ..utils.device import device_constant, on_device
from .trellis import Trellis

__all__ = ["conv_encode", "encode_scan", "puncturing", "depuncturing",
           "puncture_mask", "depuncture_device"]


_CHUNK_COMBOS = 256  # input combinations a chunk table covers per state


@functools.lru_cache(maxsize=64)
def _chunk_tables(trellis: Trellis, c: int, device: str):
    """The FSM clocked over ``c`` input symbols at once, on ``device``:
    next state ``[S, I**c]`` and output symbols ``[S, I**c, c]``, the
    chunk's first symbol the most significant digit of the combination
    index; and the digit weights ``[c]``."""
    S, I = trellis.number_states, trellis.number_inputs
    weights = I ** np.arange(c - 1, -1, -1)
    digits = (np.arange(I ** c)[:, None] // weights) % I
    state = np.repeat(np.arange(S)[:, None], I ** c, axis=1)
    outs = np.empty((S, I ** c, c), np.int64)
    for j in range(c):
        outs[:, :, j] = trellis.output_table[state, digits[:, j]]
        state = trellis.next_state_table[state, digits[:, j]]
    return tuple(torch.as_tensor(x, dtype=torch.long, device=device)
                 for x in (state, outs, weights))


def _encode_symbols(symbols: torch.Tensor, trellis: Trellis,
                    start_state: int = 0):
    """Clock the encoder FSM over packed k-bit inputs ``[..., T]``.

    The FSM steps ``c`` symbols at a time through :func:`_chunk_tables`
    (``I**c <= 256``), so a frame of T symbols takes T/c gathers of state
    and outputs instead of T; the symbols past the last whole chunk step
    one at a time.  Returns (out_bits ``[..., T, n]`` int8, final_state
    ``[...]`` int32).
    """
    dev = symbols.device
    I = trellis.number_inputs
    c = 1
    while I ** (c + 1) <= _CHUNK_COMBOS:
        c += 1
    lead, T = symbols.shape[:-1], symbols.shape[-1]
    n_chunks = T // c
    nst_c, ot_c, weights = _chunk_tables(trellis, c, str(dev))
    nst, ot = (device_constant(np.asarray(x, np.int64), dev)
               for x in (trellis.next_state_table, trellis.output_table))
    symbols = symbols.long()
    combos = (symbols[..., :n_chunks * c].reshape(lead + (n_chunks, c))
              * weights).sum(-1)
    state = torch.full(lead, start_state, dtype=torch.long, device=dev)
    outs = []
    for t in range(n_chunks):
        outs.append(ot_c[state, combos[..., t]])
        state = nst_c[state, combos[..., t]]
    for t in range(n_chunks * c, T):
        outs.append(ot[state, symbols[..., t]][..., None])
        state = nst[state, symbols[..., t]]
    outs = (torch.cat(outs, -1) if outs
            else torch.empty(lead + (0,), dtype=torch.long, device=dev))
    return unpack_bits(outs, trellis.n), state.to(torch.int32)


def _encode_feedforward(bits: torch.Tensor, trellis: Trellis) -> torch.Tensor:
    """coded[..., t*n + r] = XOR_i u[t-i] . g_taps[i, :, r] (shifted XORs)."""
    k, n = trellis.k, trellis.n
    taps = np.asarray(trellis.g_taps, np.int64)  # [depth, k, n]
    depth = taps.shape[0]
    lead = bits.shape[:-1]
    L_sym = bits.shape[-1] // k
    u = bits.reshape((-1, L_sym, k)).to(torch.int8)
    pad = torch.nn.functional.pad(u, (0, 0, depth - 1, 0))
    outs = []
    for r in range(n):
        acc = torch.zeros(u.shape[:1] + (L_sym,), dtype=torch.int8,
                          device=bits.device)
        for i in range(depth):
            for line in range(k):
                if taps[i, line, r]:
                    acc = acc ^ pad[:, depth - 1 - i: depth - 1 - i + L_sym,
                                    line]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(lead + (L_sym * n,))


def encode_scan(message_bits, trellis: Trellis, start_state: int = 0,
                device="cuda"):
    """Batched continuous ('cont') convolutional encoding on ``device``.

    message_bits : ``[..., L]`` with ``L % k == 0`` (tensor or array,
        moved to ``device``; ``'cpu'`` encodes on the host).
    Returns coded bits ``[..., L * n / k]`` (int8) and the final state.
    """
    bits = on_device(message_bits, device)
    k, n = trellis.k, trellis.n
    lead = bits.shape[:-1]
    if trellis.is_feedforward and start_state == 0:
        coded = _encode_feedforward(bits, trellis)
        # final state = last total_memory input bits, per delay line:
        # [line0 newest..oldest, line1 ...] (the trellis' state packing)
        L_sym = bits.shape[-1] // k
        u = bits.reshape(lead + (L_sym, k))
        state_bits = []
        for line, mem in enumerate(trellis.memory):
            for d in range(1, mem + 1):
                idx = L_sym - d
                if idx >= 0:
                    state_bits.append(u[..., idx, line])
                else:
                    state_bits.append(torch.zeros(lead, dtype=bits.dtype,
                                                  device=bits.device))
        if state_bits:
            final_state = pack_bits(torch.stack(state_bits, dim=-1))
        else:
            final_state = torch.zeros(lead, dtype=torch.int32,
                                      device=bits.device)
        return coded, final_state
    syms = pack_bits(bits.reshape(lead + (-1, k)))
    out_bits, final_state = _encode_symbols(syms, trellis, start_state)
    return out_bits.reshape(lead + (-1,)), final_state


def conv_encode(message_bits, trellis: Trellis, termination="term",
                puncture_matrix=None, device="cuda") -> np.ndarray:
    """Reference-compatible convolutional encoder, NumPy in and out: the
    FSM runs on ``device``, the framing and the RSC tail on the host."""
    message_bits = np.asarray(message_bits)
    k, n = trellis.k, trellis.n
    total_memory = trellis.total_memory
    rate = float(k) / n
    code_type = trellis.code_type

    nbits = message_bits.size
    if termination == "cont":
        inbits = message_bits
        number_inbits = nbits
        number_outbits = int(number_inbits / rate)
    elif code_type == "rsc":
        inbits = message_bits
        number_inbits = nbits
        number_outbits = int((number_inbits + k * total_memory) / rate)
    else:
        number_inbits = nbits + total_memory + total_memory % k
        inbits = np.zeros(number_inbits, int)
        inbits[:nbits] = message_bits
        number_outbits = int(number_inbits / rate)

    n_steps = int(number_inbits / k)
    syms = np_pack_bits(np.asarray(inbits[: n_steps * k]).reshape(n_steps, k))
    out_bits, final_state = _encode_symbols(on_device(syms, device), trellis)
    outbits = np.zeros(number_outbits, int)
    outbits[: n_steps * n] = out_bits.reshape(-1).cpu().numpy()

    # the tail drive only happens for termination == 'term' exactly
    # (reference convcode.py:542)
    if code_type == "rsc" and termination == "term":
        state = int(final_state)
        term_bits = np_unpack_bits(state, total_memory)[::-1]
        j = n_steps
        for i in range(total_memory):
            chunk = term_bits[i * k: (i + 1) * k]
            cur_in = int(np_pack_bits(chunk)) if chunk.size else 0
            cur_out = trellis.output_table[state][cur_in]
            outbits[j * n: (j + 1) * n] = np_unpack_bits(cur_out, n)
            state = trellis.next_state_table[state][cur_in]
            j += 1

    if puncture_matrix is None:
        return outbits

    # historical framing: full-length output, punctured bits packed at the
    # front, zero tail (reference convcode.py:522-558)
    pv = np.asarray(puncture_matrix)[0].ravel()
    keep = np.tile(pv, -(-number_outbits // pv.size))[:number_outbits] == 1
    p_outbits = np.zeros(number_outbits, int)
    kept = outbits[keep]
    p_outbits[: kept.size] = kept
    return p_outbits


def puncturing(message, punct_vec) -> np.ndarray:
    """Compact puncturing (reference convcode.py:752-774)."""
    message = np.asarray(message)
    pv = np.asarray(punct_vec).ravel()
    keep = np.tile(pv, -(-message.size // pv.size))[: message.size] == 1
    return message[keep]


def depuncturing(punctured, punct_vec, shouldbe: int) -> np.ndarray:
    """Zero-insertion depuncturing (reference convcode.py:777-804)."""
    punctured = np.asarray(punctured)
    pv = np.asarray(punct_vec).ravel()
    keep = np.tile(pv, -(-int(shouldbe) // pv.size))[: int(shouldbe)] == 1
    src = np.cumsum(keep) - keep
    dep = np.zeros(int(shouldbe), dtype=float)
    dep[keep] = punctured[src[keep]]
    return dep


def puncture_mask(punct_vec, length: int) -> np.ndarray:
    """Boolean keep-mask of ``length`` for batched puncturing."""
    pv = np.asarray(punct_vec).ravel()
    return np.tile(pv, -(-length // pv.size))[:length] == 1


def depuncture_device(punctured: torch.Tensor, keep_mask) -> torch.Tensor:
    """Batched depuncture: gather kept values through a static source index,
    zeros elsewhere.  punctured ``[..., n_kept]``; keep_mask bool ``[n_out]``.
    """
    keep_mask = np.asarray(keep_mask)
    # dropped slots after the last kept one point past the end: clamp
    # them (their value is masked out below)
    src = np.minimum(np.cumsum(keep_mask) - keep_mask,
                     max(punctured.shape[-1] - 1, 0))
    dev = punctured.device
    gathered = punctured[..., device_constant(src, dev)]
    zero = torch.zeros((), dtype=gathered.dtype, device=dev)
    return torch.where(device_constant(keep_mask, dev), gathered, zero)
