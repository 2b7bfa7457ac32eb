"""Turbo codes: rate-1/3 PCCC encoder and log-MAP (BCJR) decoder.

Counterpart of ``commpy_tpu/ops/turbo.py`` (reference
commpy/channelcoding/turbo.py).  Branch model of turbo.py:62-76: rate-1/2
RSC component code, BPSK (bit b -> 2b-1), codeword bit 0 systematic, bit 1
parity, branch log-probability ``-((x - cs)^2 + (y - cp)^2) / (2 sigma^2)``.

Two kinds of BCJR live in the port, on purpose, as in the JAX package:

* the cores here (``backend='torch'``) follow the JAX package's XLA cores:
  log domain, per-step normalisation by ``logsumexp``, priors as
  ``-softplus``; they are held to JAX ``backend='xla'`` within float32
  rounding;
* the K3 route (``backend='auto'|'cuda'``) drives
  :func:`~commpy_tpu_torch.kernels.bcjr.bcjr_appdiff` on w-streams with
  unnormalised metrics, as the JAX package's Pallas route does; on a CPU
  tensor that is the kernel's plain version.

The TPU code replaced gathers inside scans with one-hot permutation
matmuls; here every permutation (state tables, interleavers) is an index
gather, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.bcjr import MAX_STATES, _w_tables, bcjr_appdiff, bcjr_plan
from ..utils.bits import np_unpack_bits
from ..utils.device import device_constant, on_device
from .convcode import conv_encode, encode_scan
from .interleave import inverse_permutation
from .trellis import Trellis

__all__ = [
    "turbo_encode",
    "turbo_encode_device",
    "map_decode",
    "map_decode_device",
    "turbo_decode",
    "turbo_decode_device",
]

_BACKENDS = ("auto", "cuda", "torch")
NEG = -1e30


# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

def turbo_encode(msg_bits, trellis1: Trellis, trellis2: Trellis, interleaver,
                 device="cuda"):
    """Reference-compatible turbo encoder (turbo.py:14-59), NumPy in and
    out (the encoder FSM runs on ``device``).

    Returns [sys_stream, non_sys_stream_1, non_sys_stream_2] with the
    reference's exact lengths, including the long tail of the second
    parity stream.
    """
    msg_bits = np.asarray(msg_bits)
    stream = conv_encode(msg_bits, trellis1, "rsc", device=device)
    sys_stream = stream[::2]
    non_sys_stream_1 = stream[1::2]

    interlv_msg_bits = interleaver.interlv(sys_stream)
    puncture_matrix = np.array([[0, 1]])
    non_sys_stream_2 = conv_encode(interlv_msg_bits, trellis2, "rsc",
                                   puncture_matrix, device=device)

    sys_stream = sys_stream[0: -trellis1.total_memory]
    non_sys_stream_1 = non_sys_stream_1[0: -trellis1.total_memory]
    non_sys_stream_2 = non_sys_stream_2[0: -trellis2.total_memory]
    return [sys_stream, non_sys_stream_1, non_sys_stream_2]


def turbo_encode_device(msg_bits, trellis1: Trellis, trellis2: Trellis,
                        p_array, device="cuda"):
    """Batched turbo encoder on ``device``.

    msg_bits: ``[..., L]``; p_array: interleaver permutation ``[L]``.
    Returns (sys, par1, par2) int8, each ``[..., L]``: the parts a turbo
    decoder consumes.  ``turbo_encode`` passes termination 'rsc', which in
    the reference means no tail drive, so the streams are the main body.
    """
    bits = on_device(msg_bits, device)
    L = bits.shape[-1]
    lead = bits.shape[:-1]
    out1, _ = encode_scan(bits, trellis1, device=bits.device)
    out1 = out1.reshape(lead + (L, trellis1.n))
    sys = out1[..., 0]
    par1 = out1[..., 1]
    interleaved = sys[..., device_constant(np.asarray(p_array, np.int64),
                                           bits.device)]
    out2, _ = encode_scan(interleaved, trellis2, device=bits.device)
    par2 = out2.reshape(lead + (L, trellis2.n))[..., 1]
    return sys, par1, par2


# --------------------------------------------------------------------------
# Host tables
# --------------------------------------------------------------------------

def _bcjr_tables_np(trellis: Trellis):
    """Host constant tables: (nst, cs, cp, pred_state, pred_input)."""
    nst = trellis.next_state_table.astype(np.int32)
    bits = np_unpack_bits(trellis.output_table, trellis.n)  # [S, I, n]
    cs = (2.0 * bits[..., 0] - 1.0).astype(np.float32)
    cp = (2.0 * bits[..., 1] - 1.0).astype(np.float32)
    return (nst, cs, cp, trellis.pred_state_table,
            trellis.pred_input_table)


def _torch_tables(trellis: Trellis, dev):
    """The BCJR tables as device tensors: nst, pred_state [S, I] long; cs,
    cp [S, I]; cs, cp of the predecessor branches [S, I]; pred_input == 1
    [S, I] bool."""
    nst, cs, cp, ps, pu = _bcjr_tables_np(trellis)
    c = lambda x: device_constant(np.asarray(x), dev)  # noqa: E731
    return (c(nst.astype(np.int64)), c(ps.astype(np.int64)), c(cs), c(cp),
            c(cs[ps, pu]), c(cp[ps, pu]), c(pu == 1))


def _lse_fns(max_log: bool):
    """(lse2, lseS): pairwise and over-states log-sum-exp, or max."""
    if max_log:
        return torch.maximum, lambda x, dim: torch.amax(x, dim=dim)
    return torch.logaddexp, lambda x, dim: torch.logsumexp(x, dim=dim)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# Log-MAP decoding, the XLA-order cores
# --------------------------------------------------------------------------

def _log_bcjr(sys_symbols, par_symbols, L_int, noise_variance,
              trellis: Trellis, compute_decode: bool = True,
              max_log: bool = False):
    """Sequential log-domain BCJR over ``[B, T]`` (per-step normalised).

    Returns (lappr ``[B, T]``, decisions int8 or None).
    """
    B, T = sys_symbols.shape
    dev = sys_symbols.device
    nst, ps, cs, cp, cs_re, cp_re, pu1 = _torch_tables(trellis, dev)
    S, I = nst.shape
    lse2, lseS = _lse_fns(max_log)
    nv = torch.as_tensor(noise_variance, dtype=torch.float32, device=dev)

    x = sys_symbols[..., None, None] - cs  # [B, T, S, I]
    y = par_symbols[..., None, None] - cp
    lgamma = -(x * x + y * y) / (2.0 * nv)
    lp1 = -_softplus(-L_int)  # log p(u=1)
    lp0 = -_softplus(L_int)
    lg_priored = lgamma + torch.stack([lp0, lp1], -1)[:, :, None, :]
    xr = sys_symbols[..., None, None] - cs_re
    yr = par_symbols[..., None, None] - cp_re
    lgp_re = -(xr * xr + yr * yr) / (2.0 * nv) + torch.where(
        pu1, lp1[..., None, None], lp0[..., None, None])

    # backward: betas[:, t] = beta_{t+1}, the value the APP at t consumes
    beta = torch.zeros((B, S), dtype=torch.float32, device=dev)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        betas[t] = beta
        acc = beta[:, nst[:, 0]] + lg_priored[:, t, :, 0]
        for u in range(1, I):
            acc = lse2(acc, beta[:, nst[:, u]] + lg_priored[:, t, :, u])
        beta = acc - lseS(acc, -1)[..., None]

    alpha = torch.full((B, S), NEG, dtype=torch.float32, device=dev)
    alpha[:, 0] = 0.0
    apps = []
    for t in range(T):
        beta_next = betas[t]
        apps.append(torch.stack(
            [lseS(alpha + lgamma[:, t, :, u] + beta_next[:, nst[:, u]], -1)
             for u in range(I)], -1))
        acc = alpha[:, ps[:, 0]] + lgp_re[:, t, :, 0]
        for j in range(1, I):
            acc = lse2(acc, alpha[:, ps[:, j]] + lgp_re[:, t, :, j])
        alpha = acc - lseS(acc, -1)[..., None]
    apps = torch.stack(apps, 1)  # [B, T, I]
    lappr = L_int + apps[..., 1] - apps[..., 0]
    decoded = (lappr > 0).to(torch.int8) if compute_decode else None
    return lappr, decoded


def _log_bcjr_parallel(sys_symbols, par_symbols, L_int, noise_variance,
                       trellis: Trellis, compute_decode: bool = True,
                       max_log: bool = False):
    """BCJR with O(log T) sequential depth: the recursions are chains of
    log-semiring matrix products, composed by an inclusive prefix scan
    written out as ceil(log2 T) doubling rounds of ``logmm``."""
    B, T = sys_symbols.shape
    dev = sys_symbols.device
    nst, _, cs, cp, _, _, _ = _torch_tables(trellis, dev)
    S = nst.shape[0]
    neg = -3e37
    lse = ((lambda x, dim: torch.amax(x, dim=dim)) if max_log
           else (lambda x, dim: torch.logsumexp(x, dim=dim)))
    nv = torch.as_tensor(noise_variance, dtype=torch.float32, device=dev)

    x = sys_symbols[..., None, None] - cs
    y = par_symbols[..., None, None] - cp
    lgamma = -(x * x + y * y) / (2.0 * nv)
    lp1 = -_softplus(-L_int)
    lp0 = -_softplus(L_int)
    lg_priored = lgamma + torch.stack([lp0, lp1], -1)[:, :, None, :]

    # M[b, t, s, s'] = lg_priored[b, t, s, u] where nst[s, u] == s'
    s_next = torch.arange(S, device=dev)[None, :]
    M = torch.full((B, T, S, S), neg, dtype=torch.float32, device=dev)
    for u in range(nst.shape[1]):
        onehot = nst[:, u][:, None] == s_next
        M = torch.where(onehot, lg_priored[:, :, :, u][..., None], M)

    def logmm(a, b):  # c[i, j] = LSE_k a[i, k] + b[k, j], renormalised
        c = lse(a[..., :, :, None] + b[..., None, :, :], -2)
        return c - torch.amax(c, dim=(-2, -1), keepdim=True)

    def prefix(m):  # inclusive scan along the time axis (dim 1)
        d = 1
        while d < T:
            m = torch.cat([m[:, :d], logmm(m[:, :-d], m[:, d:])], 1)
            d *= 2
        return m

    P = prefix(M)
    alpha0 = torch.full((B, S), neg, dtype=torch.float32, device=dev)
    alpha0[:, 0] = 0.0
    alphas_tail = lse(alpha0[:, None, :, None] + P, -2)  # alpha_t, t >= 1
    alphas = torch.cat([alpha0[:, None], alphas_tail[:, :-1]], 1)

    # suffix products as a forward scan of the time-reversed transposes
    Rs = prefix(torch.flip(M.transpose(-1, -2), [1]))
    beta_T = torch.zeros((B, S), dtype=torch.float32, device=dev)
    betas_pos = lse(torch.flip(Rs, [1]) + beta_T[:, None, :, None], -2)
    betas = torch.cat([betas_pos[:, 1:], beta_T[:, None]], 1)

    app = lse(alphas[..., None] + lgamma + betas[:, :, nst], 2)  # [B, T, I]
    lappr = L_int + app[..., 1] - app[..., 0]
    decoded = (lappr > 0).to(torch.int8) if compute_decode else None
    return lappr, decoded


def _log_bcjr_windowed(sys_symbols, par_symbols, L_int, noise_variance,
                       trellis: Trellis, compute_decode: bool = True,
                       max_log: bool = False, chunk: int = 256,
                       warmup: int = 32):
    """Sliding-window BCJR: ``ceil(T/chunk)`` sub-blocks decoded at once
    (folded into the batch axis), each with ``warmup``-symbol halos whose
    recursions start from a uniform metric.  Chunk 0's alpha starts
    exactly in state 0 and the last chunk's beta is uniform; positions
    outside the frame are masked so the recursions pass through them."""
    B, T = sys_symbols.shape
    dev = sys_symbols.device
    C, W = int(chunk), int(warmup)
    Tp = -(-T // C) * C
    N = Tp // C
    Wn = W + C + W

    def windows(x):  # [B, T] -> [B*N, Wn]
        xc = F.pad(x, (0, Tp - T)).reshape(B, N, C)
        left = F.pad(xc[:, :-1, C - W:], (0, 0, 1, 0))
        right = F.pad(xc[:, 1:, :W], (0, 0, 0, 1))
        return torch.cat([left, xc, right], -1).reshape(B * N, Wn)

    gpos = (torch.arange(N, device=dev)[:, None] * C - W
            + torch.arange(Wn, device=dev)[None, :])
    valid = ((gpos >= 0) & (gpos < T))[None].expand(B, N, Wn).reshape(
        B * N, Wn)
    first = (torch.arange(N, device=dev) == 0)[None].expand(B, N).reshape(
        B * N)
    apps = _bcjr_masked(windows(sys_symbols), windows(par_symbols),
                        windows(L_int), noise_variance, trellis, valid, first,
                        max_log)
    core = apps.reshape(B, N, Wn, 2)[:, :, W:W + C, :].reshape(B, Tp, 2)
    core = core[:, :T]
    lappr = L_int + core[..., 1] - core[..., 0]
    decoded = (lappr > 0).to(torch.int8) if compute_decode else None
    return lappr, decoded


def _bcjr_masked(sy, pa, li, noise_variance, trellis: Trellis, valid, first,
                 max_log: bool, alpha_init=None, beta_init=None,
                 return_carries: bool = False):
    """Masked log-BCJR over windows: the shared core of the sliding-window
    decoder and the NII loop.

    sy/pa/li ``[R, Wn]``; ``valid [R, Wn]`` marks in-frame positions (the
    recursions pass through the others unchanged); ``first [R]`` selects
    the exact state-0 alpha start.  Returns APP log-probabilities ``[R,
    Wn, 2]`` (no prior on the decision step).  ``alpha_init`` /
    ``beta_init`` ``[R, S]`` override the start metrics; with
    ``return_carries`` the final alpha and the backward-final beta come
    back too: ``(apps, alpha_fin, beta_fin)``.
    """
    dev = sy.device
    nst, ps, cs, cp, cs_re, cp_re, pu1 = _torch_tables(trellis, dev)
    S, I = nst.shape
    R, Wn = sy.shape
    lse2, lseS = _lse_fns(max_log)
    nv = torch.as_tensor(noise_variance, dtype=torch.float32, device=dev)
    inv2nv = 1.0 / (2.0 * nv)
    valid = valid.to(torch.bool)
    first = first.to(torch.bool)

    def lgamma_t(sy_t, pa_t):  # [R, S, I]
        x = sy_t[:, None, None] - cs
        y = pa_t[:, None, None] - cp
        return -(x * x + y * y) * inv2nv

    def priors_t(li_t):
        return -_softplus(li_t), -_softplus(-li_t)  # lp0, lp1

    beta = (torch.zeros((R, S), dtype=torch.float32, device=dev)
            if beta_init is None else torch.as_tensor(beta_init, device=dev)
            .float())
    betas = [None] * Wn
    for t in range(Wn - 1, -1, -1):
        betas[t] = beta
        lp0, lp1 = priors_t(li[:, t])
        lg_t = lgamma_t(sy[:, t], pa[:, t]) + torch.stack([lp0, lp1],
                                                          -1)[:, None, :]
        acc = beta[:, nst[:, 0]] + lg_t[..., 0]
        for u in range(1, I):
            acc = lse2(acc, beta[:, nst[:, u]] + lg_t[..., u])
        new = acc - lseS(acc, -1)[..., None]
        beta = torch.where(valid[:, t, None], new, beta)
    beta_fin = beta

    if alpha_init is None:
        exact = torch.full((S,), NEG, dtype=torch.float32, device=dev)
        exact[0] = 0.0
        alpha = torch.where(first[:, None], exact[None, :],
                            torch.zeros((), device=dev))
    else:
        alpha = torch.as_tensor(alpha_init, device=dev).float()
    apps = []
    for t in range(Wn):
        sy_t, pa_t, li_t = sy[:, t], pa[:, t], li[:, t]
        lg_t = lgamma_t(sy_t, pa_t)
        beta_next = betas[t]
        apps.append(torch.stack(
            [lseS(alpha + lg_t[..., u] + beta_next[:, nst[:, u]], -1)
             for u in range(I)], -1))
        xr = sy_t[:, None, None] - cs_re
        yr = pa_t[:, None, None] - cp_re
        lp0, lp1 = priors_t(li_t)
        lgp_t = -(xr * xr + yr * yr) * inv2nv + torch.where(
            pu1, lp1[:, None, None], lp0[:, None, None])
        acc = alpha[:, ps[:, 0]] + lgp_t[..., 0]
        for j in range(1, I):
            acc = lse2(acc, alpha[:, ps[:, j]] + lgp_t[..., j])
        new = acc - lseS(acc, -1)[..., None]
        alpha = torch.where(valid[:, t, None], new, alpha)
    apps_out = torch.stack(apps, 1)  # [R, Wn, 2]
    if return_carries:
        return apps_out, alpha, beta_fin
    return apps_out


def map_decode_device(sys_symbols, non_sys_symbols, trellis: Trellis,
                      noise_variance, L_int, algorithm="log-MAP",
                      device="cuda"):
    """Batched log-MAP decode of one rate-1/2 RSC stream on ``device``.

    sys_symbols, non_sys_symbols, L_int: ``[..., T]``.
    Returns (L_ext ``[..., T]`` float32, decoded bits int8 ``[..., T]``).
    """
    squeeze = np.ndim(sys_symbols) == 1
    sy, pa, li = (torch.atleast_2d(on_device(x, device).to(torch.float32))
                  for x in (sys_symbols, non_sys_symbols, L_int))
    lappr, decoded = _log_bcjr(sy, pa, li, np.float32(noise_variance),
                               trellis, max_log=(algorithm == "max-log"))
    if squeeze:
        return lappr[0], decoded[0]
    return lappr, decoded


def map_decode(sys_symbols, non_sys_symbols, trellis: Trellis,
               noise_variance, L_int, mode="decode", device="cuda"):
    """Reference-compatible MAP decoder (turbo.py:163-251): NumPy out."""
    L_ext, decoded = map_decode_device(
        np.asarray(sys_symbols, float), np.asarray(non_sys_symbols, float),
        trellis, noise_variance, np.asarray(L_int, float), device=device)
    return [L_ext.cpu().numpy(), decoded.cpu().numpy().astype(int)]


# --------------------------------------------------------------------------
# The turbo loops
# --------------------------------------------------------------------------

def _perms(p_array, dev):
    p_np = np.asarray(p_array, np.int64)
    return (device_constant(p_np, dev),
            device_constant(inverse_permutation(p_np), dev))


def _turbo_iterations(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                      noise_variance, p_array, L_int, trellis: Trellis,
                      number_iterations: int, max_log: bool = False,
                      parallel: bool = False, window=None,
                      ext_scale: float = 1.0):
    """Extrinsic loop (turbo.py:254-333) on the XLA-order cores; ``[B, L]``
    in, decisions int8 ``[B, L]`` out."""
    if window is not None:
        chunk, warmup = window

        def bcjr(*a, **k):
            return _log_bcjr_windowed(*a, chunk=chunk, warmup=warmup, **k)
    elif parallel:
        bcjr = _log_bcjr_parallel
    else:
        bcjr = _log_bcjr
    p, inv_p = _perms(p_array, sys_symbols.device)
    sys_i = sys_symbols[:, p]
    L_int_1, L_2 = L_int, None
    for _ in range(number_iterations):
        L_ext_1, _ = bcjr(sys_symbols, non_sys_symbols_1, L_int_1,
                          noise_variance, trellis, compute_decode=False,
                          max_log=max_log)
        L_ext_1 = L_ext_1 - L_int_1
        L_int_2 = (L_ext_1 * ext_scale)[:, p]
        L_2, _ = bcjr(sys_i, non_sys_symbols_2, L_int_2, noise_variance,
                      trellis, compute_decode=False, max_log=max_log)
        L_ext_2 = L_2 - L_int_2
        L_int_1 = (L_ext_2 * ext_scale)[:, inv_p]
    # the deinterleave of exact copies commutes with the sign decision
    # (turbo.py:331)
    return (L_2[:, inv_p] > 0).to(torch.int8)


def _turbo_iterations_nii(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                          noise_variance, p_array, L_int, trellis: Trellis,
                          number_iterations: int, chunk: int,
                          max_log: bool = False, ext_scale: float = 1.0):
    """NII loop (window_init='nii') on the XLA-order masked core.

    Windows are a plain reshape (``[B, L] -> [B*N, C]``, batch-major
    rows); each window's boundary alpha/beta carries shift one window per
    iteration along the N axis.  The core normalises per step, so the
    carries need no renormalisation.
    """
    L = len(p_array)
    if L % chunk:
        raise ValueError(
            f"window_init='nii' needs chunk {chunk} to divide the frame "
            f"length {L}")
    dev = sys_symbols.device
    B = sys_symbols.shape[0]
    C = int(chunk)
    N = L // C
    R = B * N
    S = trellis.number_states
    p, inv_p = _perms(p_array, dev)

    def win(x):
        return x.reshape(R, C)

    def unwin(x):
        return x.reshape(B, L)

    sy_w = win(sys_symbols)
    pa1_w = win(non_sys_symbols_1)
    syi_w = win(sys_symbols[:, p])
    pa2_w = win(non_sys_symbols_2)
    valid_all = torch.ones((R, C), dtype=torch.bool, device=dev)
    first = torch.zeros((R,), dtype=torch.bool, device=dev)  # superseded
    exact = torch.full((S,), NEG, dtype=torch.float32, device=dev)
    exact[0] = 0.0
    a_init = torch.zeros((B, N, S), dtype=torch.float32, device=dev)
    a_init[:, 0] = exact
    a01 = a02 = a_init.reshape(R, S)
    bt1 = bt2 = torch.zeros((R, S), dtype=torch.float32, device=dev)

    def shift_states(af, bf):
        af3 = af.reshape(B, N, S)
        bf3 = bf.reshape(B, N, S)
        a0 = torch.cat([exact.expand(B, 1, S), af3[:, :N - 1]], 1)
        bT = torch.cat([bf3[:, 1:], torch.zeros((B, 1, S), device=dev)], 1)
        return a0.reshape(R, S), bT.reshape(R, S)

    li, li2, diff2 = L_int, None, None
    for _ in range(int(number_iterations)):
        apps1, af1, bf1 = _bcjr_masked(
            sy_w, pa1_w, win(li), noise_variance, trellis, valid_all, first,
            max_log, alpha_init=a01, beta_init=bt1, return_carries=True)
        a01, bt1 = shift_states(af1, bf1)
        ext1 = unwin(apps1[..., 1] - apps1[..., 0])
        li2 = (ext1 * ext_scale)[:, p]
        apps2, af2, bf2 = _bcjr_masked(
            syi_w, pa2_w, win(li2), noise_variance, trellis, valid_all,
            first, max_log, alpha_init=a02, beta_init=bt2,
            return_carries=True)
        a02, bt2 = shift_states(af2, bf2)
        diff2 = unwin(apps2[..., 1] - apps2[..., 0])
        li = (diff2 * ext_scale)[:, inv_p]
    return ((li2 + diff2)[:, inv_p] > 0).to(torch.int8)


def _turbo_iterations_cuda(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                           noise_variance, p_array, L_int, trellis: Trellis,
                           number_iterations: int, max_log: bool = False,
                           window=None, io_dtype: str = "f32",
                           window_init: str = "warmup",
                           ext_scale: float = 1.0):
    """Extrinsic loop with each MAP pass one K3 call (the JAX package's
    Pallas route, ``_turbo_iterations_pallas``).

    Streams are transposed to batch-last ``[L, B]`` and noise-scaled once,
    and the w-streams are combined once (they are loop constants).
    ``window=(chunk, warmup)`` folds the frame into ``N`` windows with
    warmup halos on the lane axis (``[L, B] -> [Wn, N*B]``) and decodes
    them all at once under the kernel's valid/first masks;
    ``window_init='nii'`` folds halo-free windows (``[L, B] -> [C, N*B]``,
    window-major lanes) and hands each window's boundary metrics to its
    neighbours for the next iteration.  The lane orders and hand-offs are
    the Pallas route's, so the two decode alike.
    """
    L = len(p_array)
    B = sys_symbols.shape[0]
    dev = sys_symbols.device
    inv_nv = float(np.float32(1.0) / np.float32(noise_variance))
    sy = sys_symbols.T.contiguous() * inv_nv  # [L, B]
    pa1 = non_sys_symbols_1.T.contiguous() * inv_nv
    pa2 = non_sys_symbols_2.T.contiguous() * inv_nv
    li = L_int.T.contiguous()
    p_np = np.asarray(p_array, np.int64)
    inv_np = inverse_permutation(p_np)
    p, inv_p = _perms(p_np, dev)
    sy_i = sy[p]

    def post(wa, wb, lint, **kw):
        return bcjr_appdiff(wa, wb, lint, trellis, max_log=max_log,
                            io_dtype=io_dtype, combined=True, posterior=True,
                            **kw)

    if window is None:
        # whole frame: the posteriors are exchanged directly
        w1, w2 = sy + pa1, sy - pa1
        w1i, w2i = sy_i + pa2, sy_i - pa2
        E2 = None
        for _ in range(number_iterations):
            E1 = post(w1, w2, li)
            li2 = ((E1 - li) * ext_scale)[p]
            E2 = post(w1i, w2i, li2)
            li = ((E2 - li2) * ext_scale)[inv_p]
        # E2 is decoder 2's posterior; the deinterleave of exact copies
        # commutes with the sign decision (turbo.py:331)
        return (E2[inv_p] > 0).to(torch.int8).T

    if window_init == "nii":
        C = int(window[0])
        if L % C:
            raise ValueError(
                f"window_init='nii' needs chunk {C} to divide the frame "
                f"length {L} (pad the frame or use window_init='warmup')")
        N = L // C
        R = N * B
        S = trellis.number_states

        def fold0(x):  # [L, B] -> [C, N*B], window-major lanes
            return x.reshape(N, C, B).permute(1, 0, 2).reshape(C, R)

        def unfold0(e):  # inverse of fold0
            return e.reshape(C, N, B).permute(1, 0, 2).reshape(L, B)

        def make_refold(perm_np):
            # fold0(perm(unfold0(e))) as one static row gather
            g = np.arange(N)[None, :] * C + np.arange(C)[:, None]  # [C, N]
            src = perm_np[g]
            idx = device_constant(((src % C) * N + src // C).reshape(-1), dev)
            return lambda e_f: e_f.reshape(C * N, B)[idx].reshape(C, R)

        refold_p = make_refold(p_np)
        refold_ip = make_refold(inv_np)
        w1_f, w2_f = fold0(sy + pa1), fold0(sy - pa1)
        w1i_f, w2i_f = fold0(sy_i + pa2), fold0(sy_i - pa2)
        exact = torch.zeros((S, B), dtype=torch.float32, device=dev)
        exact[1:] = NEG  # frame start: encoder state 0
        a0_init = torch.cat(
            [exact, torch.zeros((S, R - B), dtype=torch.float32, device=dev)],
            1)
        bT_init = torch.zeros((S, R), dtype=torch.float32, device=dev)

        def shift_states(af, bf):
            # window n's next alpha start is window n-1's final alpha
            # (window 0 keeps the exact frame start); beta flows the other
            # way and the last window's stays uniform.  The metrics are
            # unnormalised: renormalise per lane so the drift cannot
            # accumulate across iterations.
            a0 = torch.cat([exact, af[:, :R - B]], 1)
            bT = torch.cat([bf[:, B:], torch.zeros((S, B), device=dev)], 1)
            a0 = a0 - torch.amax(a0, dim=0, keepdim=True)
            bT = bT - torch.amax(bT, dim=0, keepdim=True)
            return a0, bT

        a01, bt1 = a0_init, bT_init
        a02, bt2 = a0_init, bT_init
        li_f = fold0(li)
        E2_f = None
        for _ in range(number_iterations):
            E1_f, af1, bf1 = post(w1_f, w2_f, li_f, boundary=(a01, bt1))
            a01, bt1 = shift_states(af1, bf1)
            li2_f = refold_p((E1_f - li_f) * ext_scale)
            E2_f, af2, bf2 = post(w1i_f, w2i_f, li2_f, boundary=(a02, bt2))
            a02, bt2 = shift_states(af2, bf2)
            li_f = refold_ip((E2_f - li2_f) * ext_scale)
        return (unfold0(E2_f)[inv_p] > 0).to(torch.int8).T

    C, W = int(window[0]), int(window[1])
    Tp = -(-L // C) * C
    N = Tp // C
    Wn = W + C + W

    def fold(x):  # [L, B] -> [Wn, N*B]: window cores and their W halos
        xc = F.pad(x, (0, 0, 0, Tp - L)).reshape(N, C, B)
        left = F.pad(xc[:-1, C - W:], (0, 0, 0, 0, 1, 0))
        right = F.pad(xc[1:, :W], (0, 0, 0, 0, 0, 1))
        xw = torch.cat([left, xc, right], 1)  # [N, Wn, B]
        return xw.permute(1, 0, 2).reshape(Wn, N * B)

    def unfold(e):  # [Wn, N*B] -> [L, B], the core regions
        core = e[W:W + C].reshape(C, N, B)
        return core.permute(1, 0, 2).reshape(N * C, B)[:L]

    gpos = np.arange(N)[:, None] * C - W + np.arange(Wn)[None, :]
    valid_np = (gpos >= 0) & (gpos < L)  # [N, Wn]
    valid = device_constant(valid_np.T.astype(np.float32), dev)[:, :, None] \
        .expand(Wn, N, B).reshape(Wn, N * B)
    first = device_constant(np.arange(N) == 0, dev)[:, None].expand(
        N, B).reshape(N * B)

    def make_refold(perm_np):
        # fold(perm(unfold(e))) as one static row gather of [Wn*N, B]
        ok = valid_np.T  # [Wn, N]
        src = np.where(ok, perm_np[np.clip(gpos.T, 0, L - 1)], 0)
        idx = device_constant(((W + src % C) * N + src // C).reshape(-1), dev)
        return lambda e_f: e_f.reshape(Wn * N, B)[idx].reshape(
            Wn, N * B) * valid

    refold_p = make_refold(p_np)
    refold_ip = make_refold(inv_np)
    w1_f, w2_f = fold(sy + pa1), fold(sy - pa1)
    w1i_f, w2i_f = fold(sy_i + pa2), fold(sy_i - pa2)
    E2_f = None
    li_f = fold(li)
    for _ in range(number_iterations):
        E1_f = post(w1_f, w2_f, li_f, valid=valid, first=first)
        li2_f = refold_p((E1_f - li_f) * ext_scale)
        E2_f = post(w1i_f, w2i_f, li2_f, valid=valid, first=first)
        li_f = refold_ip((E2_f - li2_f) * ext_scale)
    # E2_f is decoder 2's posterior on the core regions, where refold
    # placed exact intrinsic copies
    return (unfold(E2_f)[inv_p] > 0).to(torch.int8).T


def _cuda_bcjr_fits(trellis: Trellis) -> bool:
    """Whether K3 takes this trellis: binary input, a power-of-two number
    of states that ``bcjr_plan`` accepts (at most ``MAX_STATES``) and
    bijective per-input state maps.  (The history goes to device memory
    when shared memory cannot hold it, so the frame length sets no
    limit.)"""
    S = trellis.number_states
    if trellis.number_inputs != 2 or (S & (S - 1)):
        return False
    try:
        bcjr_plan(1, S, 1)
        _w_tables(trellis)
    except (ValueError, NotImplementedError):
        return False
    return True


def turbo_route(trellis: Trellis, backend: str, device_type: str,
                parallel: bool = False) -> str:
    """The decoder's route for ``trellis`` on a tensor of ``device_type``:
    ``'kernel'`` (K3 on ``'cuda'``, its plain version on the CPU) or
    ``'torch'`` (the XLA-order cores).

    ``backend='auto'`` takes K3 for every trellis it takes
    (:func:`_cuda_bcjr_fits`) unless ``parallel``; ``'cuda'`` raises
    unless the tensor is on the card and K3 takes the trellis.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    fits = _cuda_bcjr_fits(trellis)
    if backend == "cuda":
        if device_type != "cuda":
            raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                             f"{device_type}")
        if not fits:
            raise NotImplementedError(
                "backend='cuda' takes binary trellises with a power-of-two "
                f"number of states, at most {MAX_STATES}, and bijective "
                f"per-input state maps (got {trellis.number_states} states, "
                f"{trellis.number_inputs} inputs); use backend='auto'")
        return "kernel"
    return "kernel" if backend == "auto" and fits and not parallel \
        else "torch"


def turbo_decode_device(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                        trellis: Trellis, noise_variance, number_iterations,
                        p_array, L_int=None, algorithm="log-MAP",
                        parallel=False, window=None, backend="auto",
                        kernel_io: str = "f32", window_init: str = "warmup",
                        ext_scale: float = 1.0, device="cuda"):
    """Batched turbo decode (the extrinsic loop of turbo.py:254-333).

    All symbol arrays ``[..., T]``; ``p_array`` the interleaver
    permutation.  Returns decoded bits int8 ``[..., T]`` on ``device``.

    ``algorithm``: ``"max-log"`` for max-log-MAP, anything else log-MAP.
    ``parallel=True`` uses the associative-scan BCJR on the torch route.
    ``window=(chunk, warmup)`` decodes sub-blocks in parallel with
    state-metric warmup halos.
    ``backend``: ``'auto'`` takes the K3 route (the CUDA kernel on the
    card, its plain version on a CPU tensor) for every trellis K3 takes
    (:func:`_cuda_bcjr_fits`: up to ``MAX_STATES`` = 16 states), unless
    ``parallel=True``, and the XLA-order cores for the rest; ``'cuda'``
    requires the kernel and raises on a CPU tensor or for a trellis it
    does not take; ``'torch'`` runs the XLA-order cores on any device
    (:func:`turbo_route`).
    ``kernel_io``: ``"bf16"`` rounds the kernel's streams and outputs to
    bfloat16.
    ``window_init``: ``"warmup"`` re-acquires window boundary states every
    pass from the halos; ``"nii"`` (the chunk must divide the frame)
    carries each window's boundary alpha/beta from the previous turbo
    iteration, and the warmup of ``window`` is ignored.
    ``ext_scale``: the extrinsic scaling factor (Vogt & Finger 2000); 1.0
    is the reference's unscaled exchange.
    """
    if kernel_io not in ("f32", "bf16"):
        raise ValueError('kernel_io must be "f32" or "bf16"')
    squeeze = np.ndim(sys_symbols) == 1
    sy, p1, p2 = (torch.atleast_2d(on_device(x, device).to(torch.float32))
                  for x in (sys_symbols, non_sys_symbols_1,
                            non_sys_symbols_2))
    dev = sy.device
    L_int = (torch.zeros_like(sy) if L_int is None else
             torch.atleast_2d(on_device(L_int, dev).to(torch.float32)))
    win = None if window is None else (int(window[0]), int(window[1]))
    if win is not None and win[1] > win[0]:
        raise ValueError(
            f"window warmup {win[1]} exceeds chunk {win[0]}; the halo fold "
            "needs warmup <= chunk")
    route = turbo_route(trellis, backend, dev.type, bool(parallel))
    if window_init not in ("warmup", "nii"):
        raise ValueError('window_init must be "warmup" or "nii"')
    if window_init == "nii" and win is None:
        raise ValueError("window_init='nii' requires window=(chunk, _)")
    max_log = algorithm == "max-log"
    nv = np.float32(noise_variance)
    n_it = int(number_iterations)
    if route == "kernel":
        out = _turbo_iterations_cuda(sy, p1, p2, nv, p_array, L_int, trellis,
                                     n_it, max_log, win, io_dtype=kernel_io,
                                     window_init=window_init,
                                     ext_scale=float(ext_scale))
    elif window_init == "nii":
        out = _turbo_iterations_nii(sy, p1, p2, nv, p_array, L_int, trellis,
                                    n_it, win[0], max_log,
                                    ext_scale=float(ext_scale))
    else:
        out = _turbo_iterations(sy, p1, p2, nv, p_array, L_int, trellis, n_it,
                                max_log, bool(parallel), win,
                                ext_scale=float(ext_scale))
    return out[0] if squeeze else out


def turbo_decode(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                 trellis: Trellis, noise_variance, number_iterations,
                 interleaver, L_int=None, device="cuda"):
    """Reference-compatible turbo decoder (turbo.py:254-333): decodes on
    ``device`` and returns a NumPy int array."""
    out = turbo_decode_device(
        np.asarray(sys_symbols, float), np.asarray(non_sys_symbols_1, float),
        np.asarray(non_sys_symbols_2, float), trellis, noise_variance,
        number_iterations, interleaver.p_array, L_int, device=device)
    return out.cpu().numpy().astype(int)
