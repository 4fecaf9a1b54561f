#!/usr/bin/env python3
"""Times design variants of kernel 19b (GICP's normal equations,
`lv_slam_tpu_torch/csrc/gicp.cu` `gicp_normal`) side by side on one NVIDIA
GPU, at chip_smoke.py phase 2h's shape: scan 41's 131072 prefiltered lanes
against scan 40 at phase 10's guess (46175 lanes matched within 2 m).

    python scripts/k19b_variants.py [--out FILE]

Simulates the two scans (chip_smoke's circle), builds their inputs with the
shipped kernels (K9g, K9k, K19a) and `scripts/k19b_variants.cu` (which
includes the shipped source) with `kernels/_build.py`'s nvcc flags into
`_cache/k19b_variants/`. Variants: the shipped kernel at its grid and at
1, 2, 3 and 4 blocks an SM; the shipped design's copy with its knobs
(`k19b_variants.cu`), and with each knob back as the first one-launch
design had it (a fenced ticket, the flags loaded at each round's start,
the chain unrolled 8 deep) and all three back, and the chain's next
batch loaded between this batch's adds; each one's H and g must
equal the shipped wrapper's bit for bit. Then the tiles alone (no ticket
or finish) and the finish alone (one block over the rows a tiles-only
launch left). Each is timed device-only as chip_smoke.py times a kernel
(the median over the whole calls among 20 in a torch.profiler trace).
Then one launch each of the shipped design's copy and of the first design
with %globaltimer stamps: when the blocks start, have their lane flags,
their terms, their trees and their rows, finish their tiles and pass the
ticket, and when the finishing block has compacted its first round's
flags, staged its rows and ended; with the SMs the blocks ran on, counted
as a histogram of live blocks an SM. Prints one line per variant and
writes them as JSON to FILE (default `chiprun_out/k19b_variants.json`),
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from _parent import build  # noqa: E402  (scripts/_parent.py)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def inputs(torch, cs, dev):
    """Phase 2h's K19b arguments, made on the card by the shipped kernels."""
    from lv_slam_tpu_torch.core import se3
    from lv_slam_tpu_torch.io import synthetic
    from lv_slam_tpu_torch.ops import gicp, knn

    gt = synthetic.circle_trajectory(cs.N_FULL, step=1.0)
    scans = {i: cs._simulate(i, cs.N_FULL) for i in cs.PAIR}
    target, source, _, guess = cs.registration_pair(torch, scans, gt, dev)
    src, mask = source.masked_xyz().contiguous(), source.mask.contiguous()
    tgt_grid = knn.build_grid(target.masked_xyz(), target.mask, 1.0)
    _, pts, valid = knn.knn(knn.build_grid(src, mask, 1.0), src, 8)
    cov_a, ok = gicp.regularized_covariances(pts, valid, mask)
    y = se3.transform_points_fma(guess, src)
    dists, nn_pts, nn_valid = knn.knn(tgt_grid, y, 1)
    _, nbrs, nbr_valid = knn.knn(tgt_grid, nn_pts[:, 0].contiguous(), 8)
    need = gicp.LaneTest(mask & ok, nn_valid[:, 0].contiguous(), dists[:, 0].contiguous(), 2.0)
    cov_b, _ = gicp.regularized_covariances(nbrs, nbr_valid, need=need)
    return (src, mask & ok, cov_a, guess, nn_pts[:, 0].contiguous(), dists[:, 0].contiguous(),
            nn_valid[:, 0].contiguous(), cov_b), int(need.lanes().sum())


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k19b_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k19b_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    import chip_smoke as cs
    from lv_slam_tpu_torch.kernels._build import CSRC, ptr, scratch_bytes
    from lv_slam_tpu_torch.ops import gicp
    from lv_slam_tpu_torch.ops.ndt import finish_counter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    lib = build(CSRC, [str(ROOT / "scripts" / "k19b_variants.cu")], ROOT / "_cache" / "k19b_variants")
    fn = next(iter(lib.values())).k19b_variant
    fn.argtypes, fn.restype = [I, I] + [P] * 8 + [I, F, P, P, P, P, P], ctypes.c_int
    a, n_matched = inputs(torch, cs, dev)
    n = a[0].shape[0]
    scratch = torch.empty((scratch_bytes("lvs_gicp_normal_scratch_bytes", n),), dtype=torch.uint8, device=dev)
    counter = finish_counter(dev)
    out = torch.empty((42,), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(mode, blocks, stamps=None):
        err = fn(mode, blocks, *(ptr(t) for t in a), n, 2.0, ptr(scratch), ptr(counter), ptr(out),
                 None if stamps is None else ptr(stamps), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"k19b_variant({mode}, {blocks}) failed with CUDA error {err}")
        return out

    h, g = gicp.gicp_normal_equations(*a, 2.0)
    want = torch.cat([h.reshape(-1), g]).view(torch.int32).clone()
    rows, failed = [], []
    shipped_ms = cs.device_ms(torch, lambda: gicp.gicp_normal_equations(*a, 2.0), ("gicp_normal",))[0]
    rows.append(dict(variant="shipped wrapper", ms=shipped_ms))
    print(f"{n_matched} matched of {n} lanes; shipped wrapper {shipped_ms:.4f} ms", flush=True)
    variants = [("the shipped kernel, its grid", 0, 0),
                *((f"the shipped kernel, {k} blocks an SM", 0, k * sms) for k in (1, 2, 3, 4)),
                ("the shipped design's copy (stamped form)", 3, 0),
                ("the first one-launch design: fenced ticket, flags at each round's start, chain unrolled 8", 4, 0),
                ("the shipped design with the fenced ticket", 5, 0),
                ("the shipped design with the flags at each round's start", 6, 0),
                ("the shipped design with the chain unrolled 8 deep", 7, 0),
                ("the shipped design with the chain's next batch loaded between this batch's adds", 8, 0),
                ("the tiles alone (no ticket, no finish)", 1, 0),
                ("the finish alone (one block)", 2, 0)]
    for what, mode, blocks in variants:
        if mode == 2:
            launch(1, 0)
        got = launch(mode, blocks).view(torch.int32).clone()
        same = mode == 1 or bool(torch.equal(got, want))
        ms = cs.device_ms(torch, lambda m=mode, b=blocks: launch(m, b), ("gicp_normal",) if mode == 0 else ("variant",))[0]
        rows.append(dict(variant=what, mode=mode, blocks=blocks, ms=ms, bit_identical=same))
        if not same:
            failed.append(what)
        print(f"{what}: {ms:.4f} ms{'' if same else ' (H, g DIFFER from the shipped kernel)'}", flush=True)

    # one stamped launch of the shipped design and of the first one: the phases' spans (ns)
    for stamped in (3, 4):
        stamp_rows(torch, launch, stamped, rows)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=smi, matched=n_matched, lanes=n, rows=rows), indent=1))
    if failed:
        print(f"k19b_variants: not bit-identical: {failed}", flush=True)
        return 1
    return 0


def stamp_rows(torch, launch, mode, rows):
    stamps = torch.zeros((11 * 1024,), dtype=torch.int64, device="cuda")
    launch(mode, 0, stamps)
    torch.cuda.synchronize()
    s = stamps.view(-1, 11).cpu().numpy().astype(np.int64)
    used = s[:, 0] > 0
    t0 = int(s[used, 0].min())

    def at(k):  # the latest stamp k over the blocks that wrote it, us after the first block's start
        w = s[:, k] > 0
        return (int(s[w, k].max()) - t0) / 1e3 if w.any() else None

    spans = dict(blocks=int(used.sum()), live_blocks=int((s[:, 4] > 0).sum()), last_block_start_us=at(0),
                 flags_in_us=at(4), terms_done_us=at(5), trees_done_us=at(6), rows_written_us=at(7),
                 tiles_done_us=at(1), tickets_done_us=at(2), finish_flags_compacted_us=at(8),
                 finish_rows_staged_us=at(9), finish_done_us=at(3),
                 live_blocks_an_sm=np.bincount(np.bincount(s[s[:, 4] > 0, 10])).tolist())
    rows.append(dict(variant=f"stamped mode {mode}", **spans))
    print(f"stamps of mode {mode} (us from the first block's start): {spans}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
