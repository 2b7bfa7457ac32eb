"""Plain reference of the polar link (N = 1024, A = 512 + CRC11, QPSK,
CRC-aided list decoding with L = 8).

bits ``[F, A]`` -> CRC11 of TS 38.212 5.1 (zero register, the 11 parity
bits appended after the payload, the coefficient of D^10 first) -> u:
the K = A + 11 bits on the info positions in increasing index, 0 on the
frozen ones -> x = u G_N, G_N the n-fold Kronecker power of F = [[1, 0],
[1, 1]] (5.3.1.2, no bit reversal) -> QPSK of TS 38.211 5.1.3, (x_2i,
x_2i+1) -> ((1 - 2 x_2i) + j (1 - 2 x_2i+1)) / sqrt(2) -> complex AWGN
``s + n noise_std / 2`` -> exact LLRs at ``noise_std^2`` (``qam.py``),
negated so that positive means bit 0 -> CA-SCL -> the A payload bits.

The frozen set (the configuration's ``assumed``): the Bhattacharyya
parameters of the N synthetic channels at the design Es/N0, in the log
domain in float64 (``log z- = log z + log(2 - z)``, ``log z+ = 2 log
z``, index 2i the degraded child of i and 2i + 1 the upgraded one, most
significant bit first); the K most reliable channels carry information,
ties to the higher index.

The decoder: a recursive successive-cancellation list decoder over the
tree, min-sum f = sign(a) sign(b) min(|a|, |b|) and g = b + a or b - a by
the left child's partial sum, float32 path metrics summed leaf by leaf
(deciding u against a leaf LLR l costs max(-l, 0) for u = 0 and max(l,
0) for u = 1), slots not yet branched at 1e30.  An info leaf ranks the
2L candidates ``bit * L + parent`` by metric, ties to the lower index,
and keeps the L first in that order.  At the end each path's payload is
re-encoded: a path whose CRC differs gets 1e20 added to its metric, and
the least metric wins, ties to the lower path.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .draws import noise_std as _noise_std
from .qam import Qam

TABLE = json.loads((Path(__file__).parent / "data" / "polar1024.json")
                   .read_text())
INACTIVE = 1e30
CRC_FAIL = 1e20


def bhattacharyya_frozen(N: int, k: int, design_snr_db: float) -> np.ndarray:
    """The frozen mask [N] (True = frozen) with ``k`` info positions."""
    lz = np.array([-(10.0 ** (design_snr_db / 10.0))], np.float64)
    while lz.size < N:
        child = np.empty(2 * lz.size, np.float64)
        child[0::2] = lz + np.log(2.0 - np.exp(lz))
        child[1::2] = 2.0 * lz
        lz = child
    reliability = -lz
    order = sorted(range(N), key=lambda i: (-reliability[i], -i))
    frozen = np.ones(N, bool)
    frozen[order[:k]] = False
    return frozen


def crc_table(exponents, A: int) -> np.ndarray:
    """``[A, L]`` 0/1: row i the CRC of the payload with only bit i set
    (bit i the coefficient of D^(A-1-i) of the payload polynomial)."""
    L = max(exponents)
    g = sum(1 << e for e in exponents)
    rows = np.zeros((A, L), np.float32)
    for i in range(A):
        r = 1 << (A - 1 - i + L)
        for d in range(r.bit_length() - 1, L - 1, -1):
            if (r >> d) & 1:
                r ^= g << (d - L)
        rows[i] = [(r >> (L - 1 - c)) & 1 for c in range(L)]
    return rows


def f_minsum(a, b):
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


class Polar1024:
    def __init__(self, config: dict, device):
        self.device = device
        self.frame_bits = A = int(config["frame_bits"])
        self.N = N = int(config["mother_length"])
        self.list_size = int(config["list_size"])
        self.crc = crc_table(TABLE["crc11_exponents"], A)
        self.k_total = A + self.crc.shape[1]
        self.frozen = bhattacharyya_frozen(N, self.k_total,
                                           float(config["design_snr_db"]))
        self.info = torch.as_tensor(np.flatnonzero(~self.frozen),
                                    device=device)
        self.crc_t = torch.as_tensor(self.crc, device=device)
        iq = np.asarray(TABLE["qpsk_b0b1_to_IQ"], np.float64)
        pts = ((iq[:, 0] + 1j * iq[:, 1]) / np.sqrt(TABLE["qpsk_scale"])
               ).astype(np.complex64)
        self.es = float(np.mean(np.abs(pts.astype(np.complex128)) ** 2))
        self.qam = Qam(4, device)
        self.qam.points = torch.as_tensor(pts, device=device)
        self.n_symbols = N // 2
        self.rate = A / N

    def noise_std(self, snr_db: float) -> float:
        return _noise_std(snr_db, self.rate, self.es)

    # ------------------------------------------------------------ transmit

    def crc_bits(self, payload: torch.Tensor) -> torch.Tensor:
        """``[..., A]`` 0/1 -> the CRC ``[..., 11]`` int8."""
        return torch.remainder(payload.to(torch.float32) @ self.crc_t,
                               2.0).to(torch.int8)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[F, A]`` -> the codeword ``[F, N]`` int8."""
        F = bits.shape[0]
        u = torch.zeros((F, self.N), dtype=torch.int8, device=bits.device)
        u[:, self.info] = torch.cat([bits, self.crc_bits(bits)], 1)
        h = 1
        while h < self.N:
            v = u.view(F, -1, 2, h)
            v[:, :, 0] ^= v[:, :, 1]
            h *= 2
        return u

    def modulate(self, coded: torch.Tensor) -> torch.Tensor:
        g = coded.reshape(coded.shape[0], -1, 2).long()
        return self.qam.points[2 * g[..., 0] + g[..., 1]]

    # ------------------------------------------------------------- decode

    def decode(self, llr: torch.Tensor) -> torch.Tensor:
        """LLRs ``[F, N]`` (positive means 0, in their dtype) -> the
        payload ``[F, A]`` int8."""
        F, P, dtype = llr.shape[0], self.list_size, llr.dtype
        pm = torch.full((F, P), INACTIVE, dtype=dtype, device=llr.device)
        pm[:, 0] = 0
        state = {"pm": pm, "j": 0, "u": torch.zeros(
            (F, P, self.k_total), dtype=torch.int8, device=llr.device)}
        self._node(llr[:, None, :].expand(F, P, self.N), 0, state)
        u = state["u"]
        payload = u[..., :self.frame_bits]
        ok = torch.all(self.crc_bits(payload) == u[..., self.frame_bits:],
                       -1)
        fail = torch.full((), CRC_FAIL, dtype=dtype, device=llr.device)
        score = state["pm"] + torch.where(ok, torch.zeros_like(fail), fail)
        win = torch.argmin(score, 1)
        return payload[torch.arange(F, device=llr.device), win]

    def _node(self, alpha, lo, state):
        """Decode the subtree of leaves ``lo .. lo + W`` from its LLRs
        ``alpha [F, P, W]``.  Returns its partial sums ``[F, P, W]`` (0/1
        in alpha's dtype) and the map from the paths after it to the
        paths before it (None if unchanged)."""
        W = alpha.shape[-1]
        if W == 1:
            leaf = alpha[..., 0]
            pen0 = torch.clamp_min(-leaf, 0)
            if self.frozen[lo]:
                state["pm"] = state["pm"] + pen0
                return torch.zeros_like(alpha), None
            P = self.list_size
            cand = torch.cat([state["pm"] + pen0,
                              state["pm"] + torch.clamp_min(leaf, 0)], 1)
            order = torch.sort(cand, dim=1, stable=True).indices[:, :P]
            state["pm"] = torch.gather(cand, 1, order)
            parent, bit = order % P, order // P
            u = torch.gather(state["u"], 1, parent[..., None].expand(
                -1, -1, self.k_total))
            u[:, :, state["j"]] = bit.to(torch.int8)
            state["u"], state["j"] = u, state["j"] + 1
            return bit[..., None].to(alpha.dtype), parent
        h = W // 2
        a, b = alpha[..., :h], alpha[..., h:]
        left, p1 = self._node(f_minsum(a, b), lo, state)
        if p1 is not None:
            idx = p1[..., None].expand(-1, -1, h)
            a, b = torch.gather(a, 1, idx), torch.gather(b, 1, idx)
        right, p2 = self._node(torch.where(left > 0, b - a, b + a),
                               lo + h, state)
        if p2 is not None:
            left = torch.gather(left, 1, p2[..., None].expand(-1, -1, h))
            p1 = p2 if p1 is None else torch.gather(p1, 1, p2)
        return torch.cat([(left - right).abs(), right], -1), p1

    def transceive(self, bits, noise, noise_std: float, dtype=torch.float32):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            symbols = self.modulate(self.encode(bits))
            yr, yi = self.qam.channel(symbols, noise, noise_std, dtype)
            return self.decode(-self.qam.llr(yr, yi, noise_std)), {}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def chain(config: dict, device) -> Polar1024:
    return Polar1024(config, device)
