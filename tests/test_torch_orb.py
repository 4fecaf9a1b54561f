"""The port's ORB (`lv_slam_tpu_torch.ops.orb`, kernel 12's and 12b's plain
twins) against `lv_slam_tpu.ops.orb` (CPU), at the main path's 128 x 256
camera size, on the reference benchmark's circle images and on images built
to put ties at the top-K cut and keypoints on the border.

Exact where the reference is: the pyramid step and the bit packing, the
keypoints, their order, scores and valid flags, the match scores. A
descriptor bit may differ only where the reference's float32 arithmetic and
the port's exact float64 one round a rotated BRIEF sample differently: the
test recomputes every sample coordinate in float64 and exempts a bit only
when one of its coordinates lies within 1e-3 of a half-integer; such bits
must be under 0.1 % of all bits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small CPU ops: more threads per xdist worker only oversubscribe the cores

import jax.numpy as jnp  # noqa: E402

from lv_slam_tpu.io import synthetic  # noqa: E402
from lv_slam_tpu.ops import orb as jorb  # noqa: E402
from lv_slam_tpu_torch.ops import orb  # noqa: E402

K_LEVELS = (221, 166, 124)  # OrbExtractor(512)._k_levels(128, 256), the main path's


@pytest.fixture(scope="module")
def circle_images():
    """Camera images of the reference benchmark's circle (world seed 5), at
    four places around it: uint8 (4, 128, 256)."""
    world = synthetic.make_world(seed=5)
    gt = synthetic.circle_trajectory(170, step=1.0)
    return np.stack([synthetic.render_camera_image(world, gt[i], seed=5) for i in (0, 45, 90, 135)])


def _tiles() -> np.ndarray:
    """A constant background with one bright pixel per 8 x 8 tile: hundreds
    of corners with equal scores, so the top-K cut falls inside a tie."""
    img = np.full((128, 256), 50, np.uint8)
    img[4::8, 4::8] = 200
    return img


def _noise() -> np.ndarray:
    """Texture everywhere: corners on the 16-pixel border rows and columns,
    whose rotated BRIEF samples are clipped into the wrapped blur."""
    return np.random.default_rng(3).integers(0, 256, (128, 256)).astype(np.uint8)


def _samples(img: np.ndarray, kpts: np.ndarray):
    """The rotated BRIEF sample coordinates (y1, x1, y2, x2), each (K, 256),
    in float64 from the exact moments, before rounding and clipping."""
    h, w = img.shape
    disc = orb._DISC
    py = np.clip(kpts[:, :1] + disc[None, :, 0], 0, h - 1)
    px = np.clip(kpts[:, 1:] + disc[None, :, 1], 0, w - 1)
    patch = img.astype(np.float64)[py, px]
    theta = np.arctan2((patch * disc[:, 0]).sum(1), (patch * disc[:, 1]).sum(1)).astype(np.float32)
    c = np.cos(theta.astype(np.float64))[:, None]
    s = np.sin(theta.astype(np.float64))[:, None]
    pat = orb._PATTERN.astype(np.float64)
    out = []
    for y, x in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        out += [kpts[:, :1] + x * s + y * c, kpts[:, 1:] + x * c - y * s]
    return out


def _near_half(img: np.ndarray, kpts: np.ndarray) -> np.ndarray:
    """(K, 256) bool: a BRIEF pair with a rotated sample coordinate within
    1e-3 of a half-integer."""
    return np.any([np.abs(v - np.floor(v) - 0.5) < 1e-3 for v in _samples(img, kpts)], axis=0)


def _assert_bits(got: np.ndarray, want: np.ndarray, near: np.ndarray) -> int:
    """Descriptor bits equal but at near-half-integer samples, those under 0.1 %."""
    differ = got != want
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
    assert differ.sum() <= 1e-3 * differ.size, (int(differ.sum()), differ.size)
    return int(differ.sum())


def test_halve_and_bit_packing():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (4, 128, 256)).astype(np.float32)
    for _ in range(3):  # levels are multiples of 1/4, then 1/16
        got = orb._halve(torch.from_numpy(img)).numpy()
        want = np.stack([np.asarray(jorb._halve(jnp.asarray(im))) for im in img])
        np.testing.assert_array_equal(got, want)
        img = want
    bits = rng.random((300, 256)) < 0.5
    packed = orb._pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jorb._pack_bits_device(jnp.asarray(bits))))
    np.testing.assert_array_equal(packed, jorb.pack_descriptors(bits))
    np.testing.assert_array_equal(orb.pack_descriptors(bits), packed)
    np.testing.assert_array_equal(orb.unpack_descriptors(packed), jorb.unpack_descriptors(packed))
    np.testing.assert_array_equal(orb._unpack_bits(torch.from_numpy(packed)).numpy(), bits)


@pytest.mark.parametrize("case", ["circle0", "circle1", "circle2", "circle3", "tiles", "noise", "flat"])
def test_detect_and_compute_matches_reference(case, circle_images):
    """Each pyramid level on its own: the valid keypoints, their order and
    scores identical, and the invalid rows too (the lowest flat indices);
    descriptor bits identical but at half-integer samples."""
    if case.startswith("circle"):
        img = circle_images[int(case[-1])].astype(np.float32)
    else:
        img = {"tiles": _tiles, "noise": _noise, "flat": lambda: np.full((128, 256), 90, np.uint8)}[case]()
        img = img.astype(np.float32)
    n_valid = []
    for k in K_LEVELS:
        jk, jd, js, jv = (np.asarray(a) for a in jorb.detect_and_compute(jnp.asarray(img), k, 20.0))
        tk, td, ts, tv = (a.numpy() for a in orb.detect_and_compute(torch.from_numpy(img), k))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(ts, js)
        _assert_bits(td, jd, _near_half(img, jk))
        n_valid.append(int(jv.sum()))
        img = np.asarray(jorb._halve(jnp.asarray(img)))
    print(case, "valid per level", n_valid)
    if case == "flat":
        assert n_valid == [0, 0, 0]
    else:
        assert n_valid[0] > 0 and n_valid[2] == 0  # level 2 (32 x 64) has no rows inside the border


def test_ties_at_the_cut():
    """Equal scores across the cut: the reference's lower-flat-index order."""
    img = _tiles().astype(np.float32)
    _, _, js, jv = (np.asarray(a) for a in jorb.detect_and_compute(jnp.asarray(img), 512, 20.0))
    assert jv.sum() > 40 and len(set(js[jv].tolist())) < jv.sum() // 4  # many equal scores
    for k in (7, 16, 40):
        jk = np.asarray(jorb.detect_and_compute(jnp.asarray(img), k, 20.0)[0])
        tk = orb.detect_and_compute(torch.from_numpy(img), k)[0].numpy()
        np.testing.assert_array_equal(tk, jk)
        flat = jk[:, 0] * 256 + jk[:, 1]
        assert (np.diff(flat) > 0).all()  # one tie group, in index order


def test_border_keypoints_sample_the_wrapped_blur():
    """A keypoint on the 16-pixel border steers samples past the image edge:
    they clip to row / column 0 (or the last), where the 3x3 blur wraps."""
    img = _noise().astype(np.float32)
    jk, jd, _, jv = (np.asarray(a) for a in jorb.detect_and_compute(jnp.asarray(img), 512, 20.0))
    tk, td, _, tv = (a.numpy() for a in orb.detect_and_compute(torch.from_numpy(img), 512))
    edge = jv & ((jk[:, 0] == 16) | (jk[:, 0] == 111) | (jk[:, 1] == 16) | (jk[:, 1] == 239))
    assert edge.sum() >= 5, int(edge.sum())
    y1, x1, y2, x2 = (np.rint(v[edge]) for v in _samples(img, jk))
    clipped = (np.minimum(y1, y2) < 0) | (np.maximum(y1, y2) > 127) | (np.minimum(x1, x2) < 0)
    clipped |= np.maximum(x1, x2) > 255
    assert clipped.any(), "no border keypoint samples past the edge"
    np.testing.assert_array_equal(tk, jk)
    _assert_bits(td[edge], jd[edge], _near_half(img, jk)[edge])


def test_pyramid_batch_layout(circle_images):
    """The (B, K, 37) rows of `_detect_pyramid_batch` on a uint8 stack: valid
    rows' keypoints (little-endian int16, scaled to level 0) and flags
    identical, descriptor bytes identical but at half-integer samples."""
    stack = np.concatenate([circle_images, _tiles()[None], _noise()[None]])
    want = np.asarray(jorb._detect_pyramid_batch(jnp.asarray(stack), K_LEVELS, 20.0))
    got = orb.detect_pyramid_batch(torch.from_numpy(stack), K_LEVELS).numpy()
    assert got.shape == want.shape == (6, sum(K_LEVELS), 37) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:, :, 36], want[:, :, 36])
    valid = want[:, :, 36].astype(bool)
    np.testing.assert_array_equal(got[:, :, 32:36][valid], want[:, :, 32:36][valid])
    flips = np.unpackbits(got[:, :, :32][valid] ^ want[:, :, :32][valid]).sum()
    assert flips <= 1e-3 * valid.sum() * 256, flips


def _chip_smoke():
    """chip_smoke.py as a module (it imports numpy only at the top): the
    edge cases that the card's checks run."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


@pytest.fixture(scope="module")
def orb_cases():
    return {name: case for name, *case in CHIP_SMOKE.orb_cases()}


@pytest.mark.parametrize("name", CHIP_SMOKE.ORB_CASE_NAMES)
def test_pyramid_batch_edge_cases(orb_cases, name):
    """Kernel 12's twin on `chip_smoke.orb_cases` (which the card holds the
    kernel to, bit for bit, against this twin) against JAX's
    `_detect_pyramid_batch`: every row's keypoint bytes and valid flag
    identical, the kept rows first in the reference's order and then the
    lowest-indexed other pixels; descriptor bits identical but at
    half-integer samples, those under 0.1 % (ties at the cut, a blank image,
    noise, a plateau of ~8000 equal keys past the select's shared memory,
    batches of 1 and 32, a 33 x 35 image whose k nears h x w)."""
    images, k_levels = orb_cases[name]
    want = np.asarray(jorb._detect_pyramid_batch(jnp.asarray(images), k_levels, 20.0))
    got = orb.detect_pyramid_batch(torch.from_numpy(images), k_levels).numpy()
    assert got.shape == want.shape == (images.shape[0], sum(k_levels), 37)
    np.testing.assert_array_equal(got[:, :, 32:], want[:, :, 32:])
    level_imgs = images.astype(np.float32)
    start, near = 0, np.zeros(got.shape[:2] + (256,), bool)
    for level, k in enumerate(k_levels):
        kpts = want[:, start:start + k, 32:36].copy().view(np.int16).astype(np.int64).reshape(-1, k, 2) >> level
        near[:, start:start + k] = [_near_half(im, kp) for im, kp in zip(level_imgs, kpts)]
        start += k
        level_imgs = np.stack([np.asarray(jorb._halve(jnp.asarray(im))) for im in level_imgs])
    got_bits, want_bits = np.unpackbits(got[:, :, :32], axis=2), np.unpackbits(want[:, :, :32], axis=2)
    _assert_bits(got_bits.reshape(-1, 256), want_bits.reshape(-1, 256), near.reshape(-1, 256))
    valid = want[:, :, 36].astype(bool)
    if name == "blank image":
        assert not valid.any()
    if name == "plateau past the shared-memory cap":
        assert valid[:, :k_levels[0]].all()


def test_extractor_single_equals_batch(circle_images):
    """`OrbExtractor.detect_and_compute` per host image equals
    `detect_and_compute_batch` on the stack, and both the reference's."""
    port, ref = orb.OrbExtractor(512, device="cpu"), jorb.OrbExtractor(512)
    batched = port.detect_and_compute_batch(torch.from_numpy(circle_images))
    for img, (bd, bk) in zip(circle_images, batched):
        sd, sk = port.detect_and_compute(img)
        np.testing.assert_array_equal(bd, sd)
        np.testing.assert_array_equal(bk, sk)
        rd, rk = ref.detect_and_compute(img)
        np.testing.assert_array_equal(sk, rk)
        assert sd.shape == rd.shape and sd.dtype == np.uint8
        assert np.unpackbits(sd ^ rd).sum() <= 1e-3 * rd.size * 8
    small = port.detect_and_compute(np.zeros((20, 20), np.uint8))
    assert small[0].shape == (0, 32) and small[1].shape == (0, 2)


def test_match_scores_match_reference(circle_images):
    """`match_scores_batch` (masked, padded to the cap, candidates padded to
    a power of two, empty and missing sets among them) and `match_score`
    give the reference's float32 scores exactly, on the same descriptors."""
    ref = jorb.OrbExtractor(512)
    sets = [ref.detect_and_compute(img)[0] for img in circle_images]
    sets.append(ref.detect_and_compute(_noise())[0])
    cands = [sets[1], sets[0], None, sets[2][:40], np.zeros((0, 32), np.uint8), sets[4]]
    for cap in (512, 128):
        want = jorb.match_scores_batch(sets[0], cands, cap=cap)
        got = orb.match_scores_batch(sets[0], cands, cap=cap, device="cpu")
        np.testing.assert_array_equal(got, want)
    print("scores", got.tolist())
    assert got[1] == 1.0 and got[2] == got[4] == 0.0 and 0.0 < got[0] < 1.0
    bits = jorb.unpack_descriptors(sets[3])  # (K, 256) bool input
    np.testing.assert_array_equal(orb.match_scores_batch(bits, cands[:2], device="cpu"),
                                  jorb.match_scores_batch(bits, cands[:2]))
    for a, b in ((sets[0], sets[1]), (sets[2][:50], sets[3]), (sets[4], sets[4][:7])):
        assert orb.match_score(a, b, device="cpu") == jorb.match_score(a, b)
    assert orb.match_scores_batch(np.zeros((0, 32), np.uint8), cands, device="cpu").tolist() == [0.0] * 6
    d = orb.hamming_matrix(torch.from_numpy(bits[:5]), torch.from_numpy(bits[:7])).numpy()
    np.testing.assert_array_equal(d, np.asarray(jorb.hamming_matrix(jnp.asarray(bits[:5]), jnp.asarray(bits[:7]))))


def test_masked_match_twin_matches_reference_on_holes_and_ties():
    """The card check's yardstick, `match_scores_masked_ref`, gives JAX's
    `_match_scores_masked` scores exactly (through `unpack_descriptors`) on
    the cases of chip_smoke's `match_cases` up to cap 300 and k = 8, and its
    special ones: masks with holes, copied rows (both argmins tie), pairs at
    exactly max_dist, all-masked candidates and query, prefix masks, four
    distinct descriptors, max_dist 1e9."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    checked = 0
    for name, a, a_mask, bs, b_masks, max_dist in chip_smoke.match_cases():
        if a.shape[0] > 512 or bs.shape[0] > 8 or (name.startswith("cap") and a.shape[0] > 300):
            continue
        want = jorb._match_scores_masked(
            jnp.asarray(jorb.unpack_descriptors(a)), jnp.asarray(a_mask),
            jnp.asarray(np.stack([jorb.unpack_descriptors(b) for b in bs])), jnp.asarray(b_masks), max_dist)
        got = orb.match_scores_masked_ref(torch.from_numpy(a), torch.from_numpy(a_mask), torch.from_numpy(bs),
                                          torch.from_numpy(b_masks), max_dist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        checked += 1
    assert checked == 10
