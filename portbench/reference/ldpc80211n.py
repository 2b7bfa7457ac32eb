"""Plain reference of the 802.11n LDPC link (Annex R, n = 1944, R = 3/4).

bits -> systematic encoder (message first, parity solved over GF(2) from
the published prototype matrix) -> Gray QAM -> complex AWGN -> exact-LLR
demapping, negated (positive means bit 0) and clipped to +-500 ->
flooding min-sum (scale 1, offset 0) that stops a frame after the first
sweep whose hard decisions satisfy every check, at most ``n_iterations``
sweeps -> the message bits.

Expansion (Annex R): block ``(i, j)`` with shift ``s`` connects check
``i Z + z`` to variable ``j Z + (z + s) mod Z``.  A sweep computes each
variable's total as the channel LLR plus its check messages, added in
the order of the checks' rows; each edge's variable-to-check message is
the total less that edge's last check message; each check sends every
edge the product of the other edges' signs (a zero's sign kept) times
their least magnitude.  A frame whose channel decisions already satisfy
every check takes no sweep.  ``transceive`` also returns the sweeps each
frame took, which the K4 roofline counts.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .draws import noise_std as _noise_std
from .qam import Qam

LLR_CLIP = 500.0
BIG = 3e38  # the least magnitude over no edge


def load_table(name: str) -> dict:
    return json.loads((Path(__file__).parent / "data" / f"{name}.json")
                      .read_text())


def parity_matrix(base: np.ndarray, Z: int) -> np.ndarray:
    """Dense H ``[Mb Z, Nb Z]`` (uint8) from the prototype."""
    Mb, Nb = base.shape
    H = np.zeros((Mb * Z, Nb * Z), np.uint8)
    z = np.arange(Z)
    for i in range(Mb):
        for j in range(Nb):
            if base[i, j] >= 0:
                H[i * Z + z, j * Z + (z + base[i, j]) % Z] = 1
    return H


def encoder_matrix(H: np.ndarray, k: int) -> np.ndarray:
    """``P [n - k, k]`` with parity = P m (mod 2), by Gauss-Jordan
    elimination of the parity columns of H."""
    m = H.shape[0]
    A = np.concatenate([H[:, k:], H[:, :k]], axis=1).copy()
    for col in range(m):
        rows = np.flatnonzero(A[col:, col]) + col
        if rows.size == 0:
            raise ValueError("the parity columns of H are singular")
        piv = rows[0]
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        hit = A[:, col].astype(bool)
        hit[col] = False
        A[hit] ^= A[col]
    return A[:, m:]


class QcLdpc:
    def __init__(self, config: dict, device):
        table = load_table(config["table"])
        base = np.asarray(table["base"], np.int64)
        Z = int(table["Z"])
        self.device = device
        self.Z, (self.Mb, self.Nb) = Z, base.shape
        self.n = self.Nb * Z
        self.frame_bits = (self.Nb - self.Mb) * Z
        self.n_iterations = int(config["n_iterations"])
        self.qam = Qam(int(config["modulation_order"]), device)
        self.n_symbols = self.n // self.qam.bps
        self.rate = self.frame_bits / self.n
        edges = [(i, j, int(base[i, j])) for i in range(self.Mb)
                 for j in range(self.Nb) if base[i, j] >= 0]
        self.n_edges = len(edges) * Z  # edges of the expanded graph
        z = np.arange(Z)
        # vidx[e]: the variable that each position of block edge e reads
        vidx = np.stack([j * Z + (z + s) % Z for _, j, s in edges])
        self.vidx = torch.as_tensor(vidx, device=device)
        starts = np.searchsorted([i for i, _, _ in edges], np.arange(self.Mb + 1))
        self.rows = [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]
        H = parity_matrix(base, Z)
        P = encoder_matrix(H, self.frame_bits)
        self.P = torch.as_tensor(P.T.astype(np.float32), device=device)

    def noise_std(self, snr_db: float) -> float:
        return _noise_std(snr_db, self.rate, self.qam.es)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        with _exact_matmul():
            parity = torch.remainder(bits.to(torch.float32) @ self.P, 2.0)
        return torch.cat([bits, parity.to(torch.int8)], dim=1)

    def totals(self, llr, c2v):
        tot = llr.clone()
        for e in range(self.vidx.shape[0]):
            idx = self.vidx[e]
            tot[:, idx] = tot[:, idx] + c2v[:, e]
        return tot

    def syndrome_bad(self, dec):
        """[F] True where a check of the frame fails."""
        d = dec.to(torch.int32)[:, self.vidx]  # [F, E, Z]
        bad = torch.zeros(dec.shape[0], dtype=torch.bool, device=dec.device)
        for a, b in self.rows:
            bad |= (d[:, a:b].sum(dim=1) % 2 != 0).any(dim=1)
        return bad

    def check_update(self, v2c):
        out = torch.empty_like(v2c)
        for a, b in self.rows:
            v = v2c[:, a:b]  # [F, K, Z]
            one = torch.ones_like(v[:, :1])
            sign = torch.where(v > 0, one, torch.where(v < 0, -one, v))
            mag = torch.abs(v)
            big = torch.full_like(mag[:, :1], BIG)
            pre_s = torch.cat([one, torch.cumprod(sign, dim=1)[:, :-1]], dim=1)
            suf_s = torch.cat([torch.cumprod(sign.flip(1), dim=1).flip(1)[:, 1:],
                               one], dim=1)
            pre_m = torch.cat([big, torch.cummin(mag, dim=1).values[:, :-1]],
                              dim=1)
            suf_m = torch.cat([torch.cummin(mag.flip(1), dim=1).values
                               .flip(1)[:, 1:], big], dim=1)
            out[:, a:b] = pre_s * suf_s * torch.minimum(pre_m, suf_m)
        return out

    def decode(self, llr: torch.Tensor):
        """LLRs ``[F, n]`` (positive means 0) -> (decisions ``[F, n]``
        int8, sweeps taken ``[F]`` int32)."""
        llr = torch.clamp(llr, -LLR_CLIP, LLR_CLIP)
        F = llr.shape[0]
        c2v = torch.zeros((F,) + tuple(self.vidx.shape), dtype=llr.dtype,
                          device=llr.device)
        dec = torch.signbit(llr)
        act = self.syndrome_bad(dec)
        sweeps = torch.zeros(F, dtype=torch.int32, device=llr.device)
        for _ in range(self.n_iterations):
            if not bool(act.any()):
                break
            sweeps += act.to(torch.int32)
            v2c = self.totals(llr, c2v)[:, self.vidx] - c2v
            c2v = torch.where(act[:, None, None], self.check_update(v2c), c2v)
            d = torch.signbit(self.totals(llr, c2v))
            dec = torch.where(act[:, None], d, dec)
            act = act & self.syndrome_bad(d)
        return dec.to(torch.int8), sweeps

    def transceive(self, bits, noise, noise_std: float, dtype=torch.float32):
        symbols = self.qam.modulate(self.encode(bits))
        yr, yi = self.qam.channel(symbols, noise, noise_std, dtype)
        dec, sweeps = self.decode(-self.qam.llr(yr, yi, noise_std))
        return dec[:, :self.frame_bits], {"sweeps": sweeps}


class _exact_matmul:
    """Float32 products without TF32, so 0/1 sums stay exact."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def chain(config: dict, device) -> QcLdpc:
    return QcLdpc(config, device)
