"""The belief-propagation sweeps K4 ran a frame over the traced window,
by the program's own counters: ``qc_bp_resident.sweeps`` (summed on the
device by the kernel) over ``qc_bp_resident.frames``.  The program
counts only while a profiler records, so set-up's warm-up round is left
out; a program without the counters reads nothing."""


def read(ctx):
    from commpy_tpu_torch.kernels.qc_bp import qc_bp_resident
    frames = getattr(qc_bp_resident, "frames", 0)
    if not frames:
        return None
    return int(qc_bp_resident.sweeps) / frames
