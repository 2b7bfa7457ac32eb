"""Frames that count toward a BER estimate (``bits_sent`` / frame bits)
as a share of the frames simulated (F per ``link.count_errors`` span)."""


def read(ctx):
    if not ctx.steps or not ctx.win.sweeps:
        return None
    return 100.0 * (ctx.counted_bits / ctx.frame_bits) / (ctx.steps * ctx.frames)
