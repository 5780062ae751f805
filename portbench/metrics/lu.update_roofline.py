"""lu.update_roofline: the trailing updates' roofline share. The least
time their work needs (sum over steps of 2 v m^2 flops, m = N - (k+1) v,
against 67 TFLOP/s; or their bytes against 3.35 TB/s, the larger),
counted from N and v, over step6_dgemm's device ms a factorization."""

from portbench import roofline


def read(run):
    t, n = run.trace, run.traced_factorizations
    if t is None or not n:
        return None
    ms = t.phase_ms().get("step6_dgemm", (0.0, 0))[0] / n
    if ms <= 0:
        return None
    bound, _by = roofline.bound_ms(*roofline.lu_update_work(run.cell.cfg["N"],
                                                           run.cell.cfg["v"]))
    return 100.0 * bound / ms
