"""The port's exit path over gloo: a rank that returns without tearing
its groups down ends 0, because ``init_parallel_env`` registers an exit
hook that waits on the collectives in flight, destroys every group and
collects the process groups while the interpreter still runs. Before the
hook, the process groups' worker and transport threads were still
running when the C++ runtime tore down, and a loaded rank could abort
("terminate called without an active exception") after its work.

Held: 4 ranks, one all-reduce on the world and on each axis group of a
dp2 x mp2 mesh; the launch ends 0, the sums are exact, no rank's log
holds "terminate called", and after the hook each rank has one thread
left (its own). A rank that called ``destroy_process_group`` itself
ends the same way: the hook is then a no-op.
"""
import json
import os

import numpy as np
import pytest

from torch_dist_harness import launch, logs, outputs

N = 4


@pytest.mark.parametrize("job", ["exit", "exit:destroy"])
def test_ranks_end_clean(job, tmp_path):
    out = str(tmp_path)
    proc = launch(job, N, {"unused": np.zeros(1)}, out)
    text = logs(out)
    assert proc.returncode == 0, proc.stderr + text
    assert "terminate called" not in text, text
    # world sum 0+1+2+3 = 6, then the dp pair sums 6 + 6, then the mp pair
    for r, o in enumerate(outputs(out, "exit", N)):
        np.testing.assert_array_equal(o["x"], np.full(4, 24.0))
        with open(os.path.join(out, f"threads.r{r}.json")) as f:
            assert len(json.load(f)) == 1, r
