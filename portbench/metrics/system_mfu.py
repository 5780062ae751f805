"""system_mfu: the whole system's share of the card's float32 peak: the
work one system needs (the factorization where it is fresh, the solves
and residuals of its sweeps, counted from N, the sweeps and the
right-hand sides) over 67 TFLOP/s times the measured window's wall time a
system. It bounds every kernel's share on the path."""

from portbench import roofline


def read(run):
    if not run.systems:
        return None
    flops = run.entry.system_flops(run.refactor, run.cell.traffic["nrhs"])
    seconds = run.window_s / run.systems
    return 100.0 * flops / (roofline.PEAK_F32_FLOPS * seconds)
