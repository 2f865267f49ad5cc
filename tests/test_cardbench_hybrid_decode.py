"""The benchmark's CPU tests of the hybrid decode kind and its reader
(``cardbench/tests/test_cardbench_hybrid_decode.py``), collected here too:
the suite's ``testpaths`` holds ``tests`` alone."""
import os
import subprocess
import sys
from pathlib import Path

from cardbench.tests.test_cardbench_hybrid_decode import (  # noqa: F401
    test_cardbench_hybrid_compare_and_the_float8_control,
    test_cardbench_hybrid_draws_repeat_a_slot_at_a_time,
    test_cardbench_hybrid_refuses_a_program_without_the_fields,
    test_cardbench_hybrid_setup_writes_the_drawn_state,
    test_cardbench_hybrid_step_work_adds_the_mamba_state,
    test_cardbench_mamba_host_ms_reader,
)

REPO = Path(__file__).resolve().parents[1]


def test_cardbench_hybrid_cell_runs_correct_in_the_suite(tmp_path):
    """``test_cardbench_hybrid_cell_runs_correct_on_the_cpu`` in a process of
    its own, as a cell runs: other tests of this suite load JAX into theirs,
    which the run's guard against JAX's modules refuses."""
    code = ("import sys; from pathlib import Path; "
            "from cardbench.tests import test_cardbench_hybrid_decode as T; "
            "T.test_cardbench_hybrid_cell_runs_correct_on_the_cpu(Path(sys.argv[1]))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-4000:]
