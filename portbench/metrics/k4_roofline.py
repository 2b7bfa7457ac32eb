"""K4, the resident QC min-sum kernel: its least time over the traced
window (``bounds.qc_bound`` of every link step's decode, with the sweeps
each frame needs by the plain reference: the first after which its
decisions satisfy every check, else the limit) as a share of the device
time of ``qc_bp_resident_kernel``."""
from portbench import bounds

KERNELS = ("qc_bp_resident_kernel",)


def read(ctx):
    c = ctx.ref.chain
    t = ctx.trace.kernel_s(*KERNELS)
    if getattr(c, "n_edges", None) is None or not t:
        return None
    sweeps = ctx.batch_extras("sweeps")
    if not sweeps or any(s is None for s in sweeps):
        return None
    least = sum(bounds.bound_s(*bounds.qc_bound(len(s), c.n, c.n_edges, s))
                for s in sweeps)
    return 100.0 * least / t
