"""Plain reference of the 802.11 BCC link (clause 17, 16-QAM, rate 3/4).

bits -> frame-synchronous scrambler (x^7 + x^4 + 1) -> K = 7 (133, 171)
encoder (CommPy's tap order, ``data/ieee80211_bcc.json``), not terminated -> rate 3/4 puncturing -> Gray 16-QAM -> complex
AWGN -> exact-LLR demapping -> depuncturing (zeros) -> soft Viterbi with
a sliding traceback of ``tb_depth`` -> descrambler.

The Viterbi decoder follows CommPy's decision rule (convcode.py): the
branch metric of a branch with output bits ``o`` is ``-o . clip(r, 500)``
with ``r`` the LLRs (positive means 1), a survivor takes the second
predecessor only when its metric is strictly smaller, the best state is
the first of the least metrics, metrics are renormalised by their
least value every step, and message bit ``p`` is decided by the
traceback that starts at step ``min(p + tb_depth - 2, T - 1)``.  The
state holds the six last inputs, the newest as its most significant bit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .draws import noise_std as _noise_std
from .qam import Qam

TABLE = json.loads((Path(__file__).parent / "data" / "ieee80211_bcc.json")
                   .read_text())
LLR_CLIP = 500.0


def scrambler_sequence(seed: int, length: int) -> np.ndarray:
    """The 127-periodic sequence from a 7-bit initial state (x1 the MSB)."""
    reg = [(seed >> (6 - i)) & 1 for i in range(7)]
    a, b = TABLE["scrambler_taps"]
    out = np.empty(length, np.int8)
    for i in range(length):
        fb = reg[a - 1] ^ reg[b - 1]
        out[i] = fb
        reg = [fb] + reg[:-1]
    return out


class Bcc:
    def __init__(self, config: dict, device):
        self.device = device
        self.frame_bits = int(config["frame_bits"])
        self.tb_depth = int(config["tb_depth"])
        self.k = TABLE["constraint_length"]
        self.memory = self.k - 1
        self.states = 1 << self.memory
        self.gens = [int(g, 8) for g in TABLE["generators_octal"]]
        self.n_out = len(self.gens)
        self.qam = Qam(int(config["modulation_order"]), device)
        n_coded = self.frame_bits * self.n_out
        pattern = np.asarray(TABLE["puncture_3_4"], bool)
        keep = np.tile(pattern, -(-n_coded // pattern.size))[:n_coded]
        self.keep = torch.as_tensor(keep, device=device)
        self.keep_idx = torch.as_tensor(np.flatnonzero(keep), device=device)
        n_kept = int(keep.sum())
        self.n_symbols = n_kept // self.qam.bps
        self.rate = self.frame_bits / n_kept
        self.steps = self.frame_bits + self.memory - 1  # ACS steps T
        self.scrambler = torch.as_tensor(
            np.tile(scrambler_sequence(int(config["scramble_seed"]), 127),
                    -(-self.frame_bits // 127))[:self.frame_bits],
            device=device)
        # taps[r][d]: generator r reads the input delayed by d (tap_order)
        self.taps = [[(g >> d) & 1 for d in range(self.k)] for g in self.gens]
        s = np.arange(self.states)
        half = self.states // 2
        pred = [((s & (half - 1)) << 1) | j for j in range(2)]
        u = s >> (self.memory - 1)  # the input that enters state s
        out = np.zeros((2, self.states, self.n_out), np.int64)
        for j in range(2):
            # the inputs delayed by 0..memory on the branch pred[j] -> s
            delayed = [u] + [(pred[j] >> (self.memory - d)) & 1
                             for d in range(1, self.k)]
            for r, taps in enumerate(self.taps):
                out[j, :, r] = np.bitwise_xor.reduce(
                    [t * x for t, x in zip(taps, delayed)], axis=0)
        self.pred = [torch.as_tensor(p, device=device) for p in pred]
        # the output word of the branch from predecessor j into each state
        self.word = [torch.as_tensor(
            (out[j] * (1 << np.arange(self.n_out - 1, -1, -1))).sum(-1)
            .astype(np.int64), device=device) for j in range(2)]

    def noise_std(self, snr_db: float) -> float:
        return _noise_std(snr_db, self.rate, self.qam.es)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """Scrambled, encoded and punctured bits ``[F, n_kept]``."""
        u = bits ^ self.scrambler
        pad = torch.nn.functional.pad(u, (self.memory, 0))
        L = self.frame_bits
        outs = []
        for taps in self.taps:
            acc = torch.zeros_like(u)
            for i, t in enumerate(taps):
                if t:
                    acc = acc ^ pad[:, self.memory - i:self.memory - i + L]
            outs.append(acc)
        coded = torch.stack(outs, dim=-1).reshape(bits.shape[0], -1)
        return coded[:, self.keep_idx]

    def depuncture(self, llr: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((llr.shape[0], self.keep.numel()), dtype=llr.dtype,
                           device=llr.device)
        full[:, self.keep_idx] = llr
        return full

    def viterbi(self, llr: torch.Tensor) -> torch.Tensor:
        """Depunctured LLRs ``[F, 2 L]`` -> message bits ``[F, L]``."""
        F, dtype, dev = llr.shape[0], llr.dtype, llr.device
        T, S, n = self.steps, self.states, self.n_out
        r = torch.clamp(llr, -LLR_CLIP, LLR_CLIP).reshape(F, -1, n)
        r = torch.cat([r, torch.zeros((F, T - r.shape[1], n), dtype=dtype,
                                      device=dev)], dim=1)
        # the metric of each of the 2^n output words, summed over n in
        # index order; a branch reads the word it emits
        words = torch.as_tensor(
            [[-float((q >> (n - 1 - i)) & 1) for i in range(n)]
             for q in range(1 << n)], dtype=dtype, device=dev)  # [2^n, n]
        bm = r[..., 0:1] * words[:, 0]
        for i in range(1, n):
            bm = bm + r[..., i:i + 1] * words[:, i]  # [F, T, 2^n]
        pm = torch.full((F, S), torch.inf, dtype=dtype, device=dev)
        pm[:, 0] = 0
        dec = torch.empty((F, T, S), dtype=torch.bool, device=dev)
        best = torch.empty((F, T), dtype=torch.long, device=dev)
        p0, p1 = self.pred
        w0, w1 = self.word
        for t in range(T):
            bm_t = bm[:, t]
            c0 = pm[:, p0] + bm_t[:, w0]
            c1 = pm[:, p1] + bm_t[:, w1]
            take = c1 < c0
            new = torch.where(take, c1, c0)
            dec[:, t] = take
            best[:, t] = torch.argmin(new, dim=1)
            pm = new - torch.amin(new, dim=1, keepdim=True)
        del bm
        p = torch.arange(T, device=dev)
        w = torch.clamp(p + (self.tb_depth - 2), max=T - 1)
        cur = best[:, w]
        rows = torch.arange(F, device=dev)[:, None]
        half = S // 2 - 1
        for i in range(min(self.tb_depth - 2, T - 1)):
            t = torch.clamp(w - i, min=0)[None, :]
            j = dec[rows, t, cur].long()
            cur = torch.where(i < w - p, ((cur & half) << 1) | j, cur)
        bits = (cur >> (self.memory - 1)).to(torch.int8)
        return bits[:, :self.frame_bits]

    def transceive(self, bits, noise, noise_std: float, dtype=torch.float32):
        symbols = self.qam.modulate(self.encode(bits))
        yr, yi = self.qam.channel(symbols, noise, noise_std, dtype)
        llr = self.depuncture(self.qam.llr(yr, yi, noise_std))
        return self.viterbi(llr) ^ self.scrambler, {}


def chain(config: dict, device) -> Bcc:
    return Bcc(config, device)
