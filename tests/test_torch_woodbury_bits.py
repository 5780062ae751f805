"""A drifted session's engine answers do not depend on how the engine
coalesces its requests.

The engine serves one session's requests in one wider solve. The Woodbury
correction of a drifted session (`update.woodbury_apply`) runs each
column through batched products of one shape and one batch count, so a
request's answer is bitwise the same whether it rides alone (its own
width bucket) or coalesced with others. A product over the whole
coalesced width sums in a width-dependent order: that is the fault this
file pins (requests of width 2 at N=1024, rank 16, alone against 2 and
16 coalesced).
"""

import numpy as np
import torch

from conflux_tpu_torch import serve
from conflux_tpu_torch.engine import ServeEngine

N, V, K = 1024, 256, 16
T = 120  # seconds: the bound of every wait


def test_drifted_answers_bitwise_alone_and_coalesced():
    serve.clear_plans()
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((N, N)) / np.sqrt(N) + 2.0 * np.eye(N)).astype(np.float32)
    # the library LU factors the base (the Woodbury path is the same on
    # every backend); the solves run K3's plain version
    plan = serve.FactorPlan.create((N, N), torch.float32, v=V, backend="xla")
    session = plan.factor(A, device="cpu")
    U = (rng.standard_normal((N, K)) / N).astype(np.float32)
    Vd = (rng.standard_normal((N, K)) / N).astype(np.float32)
    session.update(U, Vd)
    assert session.update_rank == K
    reqs = [rng.standard_normal((N, 2)).astype(np.float32) for _ in range(16)]
    with ServeEngine(max_batch_delay=0.0, device="cpu") as eng:
        alone = [eng.solve(session, b, timeout=T) for b in reqs]
    for burst in (2, 16):
        with ServeEngine(max_batch_delay=0.5, max_coalesce_width=2 * burst,
                         device="cpu") as eng:
            futs = [eng.submit(session, b) for b in reqs[:burst]]
            got = [f.result(timeout=T) for f in futs]
            assert eng.stats()["batches"] < burst  # the requests were coalesced
        for x, ref in zip(got, alone):
            np.testing.assert_array_equal(x, ref)
