"""``Trellis.visualize`` and ``visualize_fsm`` of the port against the
JAX package's, on matplotlib's Agg backend with ``show=False``.

Both draw host matplotlib figures from the trellis tables alone, so for
the same code the two figures hold the same artists: the scatter
collections' offsets, the ``Line2D`` data (edges), the annotation texts
and positions, the legend labels and the axis limits are held equal,
exactly, for K=3 (5,7), the K=3 RSC and a k=2 code.  ``save_path``
writes a file.
"""
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from commpy_tpu.ops.trellis import Trellis as JTrellis  # noqa: E402
from commpy_tpu_torch.channelcoding.convcode import Trellis as CTrellis  # noqa: E402,E501
from commpy_tpu_torch.ops.trellis import Trellis  # noqa: E402

CODES = {
    "k3_57": (np.array([2]), np.array([[5, 7]])),
    "k3_rsc": (np.array([2]), np.array([[1, 7]]), 5, "rsc"),
    "k2": (np.array([2, 1]), np.array([[5, 7, 0], [0, 2, 3]])),
}


def _artists(fig):
    """What a figure draws, axis by axis, as plain comparable values."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "offsets": [np.asarray(c.get_offsets()).tolist()
                        for c in ax.collections],
            "lines": [np.asarray(ln.get_xydata()).tolist()
                      for ln in ax.get_lines()],
            "line_colors": [tuple(np.asarray(
                matplotlib.colors.to_rgba(ln.get_color())).tolist())
                for ln in ax.get_lines()],
            "texts": [(t.get_text(), tuple(np.asarray(t.xy).tolist()),
                       matplotlib.colors.to_rgba(t.get_color()))
                      for t in ax.texts],
            "legend": None if legend is None else
            [t.get_text() for t in legend.get_texts()],
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "axis_on": ax.axison,
        })
    return out


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("kind", ["visualize", "visualize_fsm"])
def test_plot_draws_the_jax_figure(code, kind):
    kw = {"trellis_length": 4} if kind == "visualize" else {}
    figs = [getattr(T(*CODES[code]), kind)(show=False, **kw)
            for T in (JTrellis, Trellis)]
    try:
        want, got = (_artists(f) for f in figs)
        assert got == want
        drawn = got[0]
        assert drawn["offsets"] and drawn["texts"]
        if kind == "visualize":
            assert len(drawn["lines"]) == (3 * Trellis(*CODES[code])
                                           .number_states
                                           * Trellis(*CODES[code])
                                           .number_inputs)
            assert drawn["legend"] == [
                f"input {u}"
                for u in range(Trellis(*CODES[code]).number_inputs)]
    finally:
        for f in figs:
            plt.close(f)


def test_compatible_api_trellis_plots_and_save_path(tmp_path):
    """``channelcoding.convcode.Trellis`` is the same class; both plots
    write their figure to ``save_path``."""
    assert CTrellis is Trellis
    tr = CTrellis(*CODES["k3_57"])
    for kind in ("visualize", "visualize_fsm"):
        path = tmp_path / f"{kind}.png"
        fig = getattr(tr, kind)(save_path=str(path), show=False)
        plt.close(fig)
        assert path.stat().st_size > 1000
