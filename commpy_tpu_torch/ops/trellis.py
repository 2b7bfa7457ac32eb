"""Trellis construction for k/n convolutional codes (host NumPy).

Counterpart of ``commpy_tpu/ops/trellis.py`` with the same table
semantics: the matrix-feedback construction (MSB / LSB('Matlab')
polynomial formats, k > 1 inputs, RSC via a feedback matrix) and the
deprecated int-feedback shift-register emulation, quirks included.

On top of ``next_state_table`` / ``output_table`` it builds the inverse
tables the batched decoders use:

* ``pred_state[s, j]`` / ``pred_input[s, j]``: the j-th (prev_state,
  input) branch entering state ``s``, in row-major scan order of
  ``next_state_table`` (this order fixes the decoders' tie-breaks);
* ``branch_codewords[s, j, n]``: ideal output bits of that branch.

``visualize`` and ``visualize_fsm`` draw the JAX package's figures of
the trellis and of its state machine (host matplotlib, imported when
called).
"""
from __future__ import annotations

import numpy as np

from ..utils.bits import np_pack_bits, np_unpack_bits

__all__ = ["Trellis"]


class Trellis:
    """Trellis for a k/n convolutional code (see module docstring)."""

    def __init__(self, memory, g_matrix, feedback=None, code_type="default",
                 polynomial_format="MSB"):
        memory = np.atleast_1d(np.asarray(memory, dtype=int))
        g_matrix = np.atleast_2d(np.asarray(g_matrix, dtype=int))
        self.k, self.n = g_matrix.shape
        self.code_type = code_type
        self.total_memory = int(memory.sum())
        self.number_states = 2 ** self.total_memory
        self.number_inputs = 2 ** self.k
        self.memory = memory

        self.is_feedforward = False
        self.g_taps = None
        if isinstance(feedback, (int, np.integer)):
            nst, out = self._build_legacy_int_feedback(
                memory, g_matrix.copy(), int(feedback), code_type
            )
        else:
            nst, out = self._build_matrix_feedback(
                memory, g_matrix, feedback, polynomial_format
            )

        self.next_state_table = nst
        self.output_table = out
        self._build_inverse_tables()

    def _build_matrix_feedback(self, memory, g_matrix, feedback,
                               polynomial_format):
        """Matrix-feedback path (reference convcode.py:195-255)."""
        k, n = self.k, self.n
        if polynomial_format == "MSB":
            msb = True
        elif polynomial_format in ("LSB", "Matlab"):
            msb = False
        else:
            raise ValueError(
                'polynomial_format must be "LSB", "MSB" or "Matlab"')

        if feedback is None:
            feedback = np.identity(k, int)
            if not msb:
                feedback *= 2 ** memory.max()
        feedback = np.atleast_2d(np.asarray(feedback, dtype=int))

        depth = int(memory.max()) + 1  # taps per delay line

        def poly_bits(p):
            # poly_bits[i] = coefficient of D^i
            bits = np_unpack_bits(p, depth)
            return bits[::-1] if msb else bits

        fb_taps = np.zeros((depth, k, k), np.int64)
        for i in range(k):
            for j in range(k):
                fb_taps[:, i, j] = poly_bits(feedback[i, j])
        g_taps = np.zeros((depth, k, n), np.int64)
        for i in range(k):
            for j in range(n):
                g_taps[:, i, j] = poly_bits(g_matrix[i, j])

        # identity feedback (the default) means a pure binary convolution,
        # which encode_scan evaluates as shifted XORs
        ident = np.identity(k, int)
        if not msb:
            ident = ident * 2 ** memory.max()
        self.is_feedforward = bool(np.array_equal(feedback, ident))
        self.g_taps = g_taps  # [depth, k, n]

        S, I = self.number_states, self.number_inputs
        state_bits = np_unpack_bits(np.arange(S), self.total_memory)
        input_bits = np_unpack_bits(np.arange(I), k)

        # regs[S, I, depth, k]: row 0 = inputs, rows 1..mem = state bits
        regs = np.zeros((S, I, depth, k), np.int64)
        regs[:, :, 0, :] = input_bits[None, :, :]
        idx = 0
        for col, mem in enumerate(memory):
            regs[:, :, 1: mem + 1, col] = state_bits[:, None, idx: idx + mem]
            idx += mem

        out_bits = np.einsum("SIik,ikl->SIl", regs, g_taps) % 2
        output_table = np_pack_bits(out_bits).astype(int)

        new_row0 = np.einsum("SIik,ilk->SIl", regs, fb_taps) % 2
        regs[:, :, 0, :] = new_row0
        next_bits = np.empty((S, I, self.total_memory), np.int64)
        idx = 0
        for col, mem in enumerate(memory):
            next_bits[:, :, idx: idx + mem] = regs[:, :, :mem, col]
            idx += mem
        next_state_table = np_pack_bits(next_bits).astype(int)
        return next_state_table, output_table

    def _build_legacy_int_feedback(self, memory, g_matrix, feedback,
                                   code_type):
        """Deprecated int-feedback emulation (reference convcode.py:130-193),
        reproducing its shift-register sequencing and k > 1 quirks."""
        k, n = self.k, self.n
        if code_type == "rsc":
            for i in range(k):
                g_matrix[i][i] = feedback

        S, I = self.number_states, self.number_inputs
        next_state_table = np.zeros((S, I), int)
        output_table = np.zeros((S, I), int)

        for state in range(S):
            for inp in range(I):
                outbits = np.zeros(n, np.int64)
                inp_bits = np_unpack_bits(inp, k)
                shift_register = np_unpack_bits(
                    state, self.total_memory).astype(np.int64)
                for r in range(n):
                    out_gen = np.zeros(k, np.int64)
                    shift_register = np_unpack_bits(
                        state, self.total_memory).astype(np.int64)
                    fb_sum = 0
                    for l in range(k):
                        gen = np_unpack_bits(g_matrix[l][r], memory[l] + 1)
                        for i in range(memory[l]):
                            outbits[r] = (
                                outbits[r] + shift_register[i + l] * gen[i + 1]
                            ) % 2
                        out_gen[l] = gen[0]
                        if l == 0:
                            fb_sum = (
                                np_unpack_bits(feedback, memory[l] + 1)[1:]
                                * shift_register[0: memory[l]]
                            ).sum()
                            shift_register[1: memory[l]] = shift_register[
                                0: memory[l] - 1]
                            shift_register[0] = (inp_bits[0] + fb_sum) % 2
                        else:
                            lo = l + memory[l - 1] - 1
                            fb_sum = (
                                np_unpack_bits(feedback, memory[l] + 1)
                                * shift_register[lo: lo + memory[l]]
                            ).sum()
                            shift_register[lo + 1: lo + memory[l]] = (
                                shift_register[lo: lo + memory[l] - 1])
                            shift_register[lo] = (inp_bits[l] + fb_sum) % 2
                    outbits[r] = (
                        outbits[r] + (np.sum(inp_bits * out_gen + fb_sum) % 2)
                    ) % 2
                output_table[state, inp] = int(np_pack_bits(outbits))
                next_state_table[state, inp] = int(
                    np_pack_bits(shift_register))
        return next_state_table, output_table

    def visualize(self, trellis_length=2, state_order=None, state_radius=0.04,
                  edge_colors=None, save_path=None, show=True):
        """Plot the trellis diagram: states as columns of nodes over
        ``trellis_length`` time steps, one colored edge per input."""
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt

        S, I = self.number_states, self.number_inputs
        if edge_colors is None:
            edge_colors = [mcolors.hsv_to_rgb((i / I, 1, 1)) for i in range(I)]
        if state_order is None:
            state_order = list(range(S))
        pos = {s: i for i, s in enumerate(state_order)}

        fig, ax = plt.subplots(figsize=(2.5 * trellis_length, 0.6 * S + 1))
        for t in range(trellis_length):
            for s in range(S):
                ax.scatter([t], [pos[s]], s=300, c="#003399", zorder=3)
                ax.annotate(str(s), (t, pos[s]), color="w", ha="center",
                            va="center", fontsize=8, zorder=4)
        for t in range(trellis_length - 1):
            for s in range(S):
                for u in range(I):
                    ns = self.next_state_table[s, u]
                    ax.plot([t, t + 1], [pos[s], pos[ns]],
                            color=edge_colors[u], lw=1, zorder=2)
        ax.set_xticks(range(trellis_length))
        ax.set_xlabel("time step")
        ax.set_yticks([])
        ax.invert_yaxis()
        ax.legend(
            handles=[
                plt.Line2D([0], [0], color=edge_colors[u],
                           label=f"input {u}") for u in range(I)
            ],
            loc="upper right",
        )
        if save_path is not None:
            fig.savefig(save_path, bbox_inches="tight")
        if show:
            plt.show()
        return fig

    def visualize_fsm(self, state_order=None, state_radius=0.04,
                      edge_colors=None, save_path=None, show=True):
        """Plot the finite-state machine: states on a circle, one arrow
        per transition labelled with its output (small trellises only)."""
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt

        S, I = self.number_states, self.number_inputs
        if edge_colors is None:
            edge_colors = [mcolors.hsv_to_rgb((i / I, 1, 1)) for i in range(I)]
        if state_order is None:
            state_order = list(range(S))
        angles = 2 * np.pi * np.arange(S) / S
        radius = max(1.0, state_radius * S * 4)
        xy = {s: (radius * np.cos(angles[i]), radius * np.sin(angles[i]))
              for i, s in enumerate(state_order)}

        fig, ax = plt.subplots(figsize=(7, 7))
        for s, (x, y) in xy.items():
            ax.scatter([x], [y], s=600, c="#003399", zorder=3)
            ax.annotate(str(s), (x, y), color="w", ha="center", va="center",
                        zorder=4)
        for s in range(S):
            for u in range(I):
                ns = self.next_state_table[s, u]
                out = self.output_table[s, u]
                x0, y0 = xy[s]
                x1, y1 = xy[ns]
                if ns == s:
                    ax.annotate(f"({out})", (x0 * 1.25, y0 * 1.25),
                                ha="center", color=edge_colors[u])
                else:
                    ax.annotate(
                        "", (x1, y1), (x0, y0),
                        arrowprops=dict(arrowstyle="->",
                                        color=edge_colors[u],
                                        connectionstyle="arc3,rad=0.15"),
                    )
                    ax.annotate(f"({out})",
                                ((x0 + x1) / 2 * 1.15, (y0 + y1) / 2 * 1.15),
                                ha="center", fontsize=8,
                                color=edge_colors[u])
        lim = radius * 1.6
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_axis_off()
        ax.set_title("Finite State Machine (output on transition)")
        if save_path is not None:
            fig.savefig(save_path, bbox_inches="tight")
        if show:
            plt.show()
        return fig

    def _build_inverse_tables(self):
        S, I = self.number_states, self.number_inputs
        counts = np.zeros(S, int)
        pred_state = np.zeros((S, I), np.int32)
        pred_input = np.zeros((S, I), np.int32)
        # row-major scan == np.where order == reference _where_c order
        for ps in range(S):
            for u in range(I):
                ns = self.next_state_table[ps, u]
                j = counts[ns]
                if j < I:
                    pred_state[ns, j] = ps
                    pred_input[ns, j] = u
                counts[ns] = j + 1
        if not np.all(counts == I):
            raise ValueError(
                "Trellis is not input-regular: every state must have exactly "
                "2^k incoming branches (got counts %s)" % counts
            )
        self.pred_state_table = pred_state
        self.pred_input_table = pred_input
        branch_out = self.output_table[pred_state, pred_input]
        self.branch_codewords = np_unpack_bits(branch_out, self.n).astype(
            np.int32)  # [S, I, n]
        # forward-direction codeword bits [S, I_in, n]
        self.output_bits = np_unpack_bits(self.output_table, self.n).astype(
            np.int32)
