"""The port's entry points (`lv_slam_tpu_torch.entry`) against the
reference's `__graft_entry__` (CPU).

`entry()`'s odometry step on the reference's straight pair, run by both
packages, within the fused odometry's tolerances of
tests/test_torch_odometry.py (TRANS_ATOL, ROT_ATOL); `dryrun_multichip` in
a spawned gloo world of 2 (`parallel.check.spawn`), which runs the
sharded align, the sharded LM and the fleet with and without LFA on a
(1, 2) mesh and raises if an output is not finite.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax  # noqa: E402

import __graft_entry__ as ref_entry  # noqa: E402
from lv_slam_tpu_torch import entry  # noqa: E402
from lv_slam_tpu_torch.parallel import check  # noqa: E402
from test_torch_odometry import ROT_ATOL, TRANS_ATOL  # noqa: E402


def test_entry_step_matches_reference():
    fn, args = entry.entry(device="cpu")
    target, source, guess = args
    assert target.cap == source.cap == 32768 and float(guess[0, 3]) == 1.0
    transform, score, iterations = fn(*args)
    j_fn, j_args = ref_entry.entry()
    want_t, want_s, want_it = (np.asarray(a) for a in jax.jit(j_fn)(*j_args))
    got = transform.numpy()
    err_t = float(np.abs(got[:3, 3] - want_t[:3, 3]).max())
    err_r = float(np.abs(got[:3, :3] - want_t[:3, :3]).max())
    print(f"entry step: translation error {err_t:.3g} m (tolerance {TRANS_ATOL}), rotation error {err_r:.3g} "
          f"(tolerance {ROT_ATOL}); score {float(score):.2f} vs {float(want_s):.2f}, iterations "
          f"{int(iterations)} vs {int(want_it)}")
    assert err_t <= TRANS_ATOL and err_r <= ROT_ATOL
    assert np.isfinite(float(score)) and int(iterations) > 0


def test_dryrun_multichip_in_a_world_of_two(tmp_path):
    assert check.spawn(2, "dryrun", {"device": "cpu"}, tmp_path) == [{}, {}]
