#!/usr/bin/env python3
"""Re-solve a pose graph saved by `chip_smoke.py` (phase 9a writes
`chiprun_out/graph_9a.npz`: the last LM's input graph, its iteration cap and
the card's solution) with the JAX reference's `optimize_pose_graph` on the
CPU, and print how far the card's poses lie from the reference's:

    JAX_PLATFORMS=cpu python scripts/resolve_graph.py chiprun_out/graph_9a.npz
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(path: str) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")
    from lv_slam_tpu.graph import pose_graph as jpg

    z = np.load(path)
    graph = jpg.PoseGraph(**{name: jnp.asarray(z[name]) for name in jpg.PoseGraph._fields})
    result = jax.jit(jpg.optimize_pose_graph, static_argnums=(1,))(graph, int(z["iters"]))
    n = int(z["node_valid"].sum())
    diff = float(np.abs(np.asarray(result.poses)[:n] - z["card_poses"][:n]).max())
    print(f"{path}: {n} nodes, {int(z['e_valid'].sum())} edges, {int(z['p_valid'].sum())} priors, "
          f"{int(z['sp_valid'].sum())} SE3-plane edges; the reference's LM: {int(result.iterations)} iterations, chi2 "
          f"{float(result.chi2_before):.6g} -> {float(result.chi2_after):.6g}; largest difference from the card's "
          f"poses {diff:.3g}")


if __name__ == "__main__":
    main(sys.argv[1])
