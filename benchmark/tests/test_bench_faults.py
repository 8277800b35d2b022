"""The check fails a run whose timed path is broken underneath: the harness
runs on the CPU at a tiny size (its look for a card skipped) with the
port's step broken in one way (``harness/faults.py``), and ``correct``
comes out false."""
import pytest

from harness import faults
from scp_tpu_torch.ops import ipm_kernel

from test_bench_run import tiny_run

CASES = [(name, fault) for name in ("circle8.sweep", "parallel11ss.sweep")
         for fault in ("state_unchanged", "half_batch_left_out",
                       "answer_altered")]
# under SCP: the straggler phases left out (a batch in which the
# reference runs stragglers past the first phase at the sampled steps)
CASES.append(("circle8.sweep", "phases_truncated"))


@pytest.mark.parametrize("name, fault", CASES)
def test_a_broken_step_is_not_correct(name, fault):
    progs = []

    def plant(prog):
        progs.append(prog)
        faults.FAULTS[fault](prog)
    try:
        result = tiny_run(name, False, batch=4, fault=plant)
    finally:
        for prog in progs:
            getattr(prog, "restore", lambda: None)()
    assert ipm_kernel.ipm_iterate_struct.__name__ == "ipm_iterate_struct"
    assert result["correct"] is False, result["check"]
