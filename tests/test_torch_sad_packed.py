"""The packed form of kernel B9 (csrc/sad_grid.cu) on the CPU: an int64
mirror of the kernel's plan and arithmetic, held against hevcasm_tpu's SAD
grids.

The mirror follows the kernel step by step: the plan of a call (J, the
copies' row stride cs, the dy rows of a block), the window rows as words
with the bytes past the window zeroed, word x of copy c the funnel shift
by c bytes of the window's words x and x + 1, each thread's residue class
and run of J candidates, and per source row the J + B/4 window words of its run against
the B/4 source words, four absolute differences a word (vabsdiff4 with
.add).  The mirror is test code: the package's plain version of B9 stays
``ops.sad.sad_grid``.  The kernel itself is held against that plain version
in test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.ops.sad import sad_grid as jax_sad_grid

from hevcasm_tpu_torch.ops.sad import sad_grid

MAX_THREADS = 256
MIN_THREADS = 128
MAX_SMEM = 100 * 1024
CLASSES = 4


def class_words(num_dx, s):
    return (num_dx - s + 3) // 4 if num_dx > s else 0


def class_groups(num_dx, s, j):
    return -(-class_words(num_dx, s) // j)


def plan(b, num_dy, num_dx):
    """hevc_sad_grid's plan: (J, cs, dy rows a block, slices, threads)."""
    sw = b // 4
    best, best_j = None, None
    for j in (8, 4, 2):
        groups = sum(class_groups(num_dx, c, j) for c in range(CLASSES))
        cost = groups * (j * sw + (j + sw + 3) // 4 + (sw + 3) // 4)
        if best is None or cost < best:
            best, best_j = cost, j
    j = best_j
    groups = sum(class_groups(num_dx, c, j) for c in range(CLASSES))
    assert groups <= MAX_THREADS
    cs = (class_groups(num_dx, 0, j) * j + sw + 1 + 3) // 4 * 4
    if (cs // 4) % 2 == 0:
        cs += 4

    def smem(rows):
        return (b * sw + CLASSES * (rows + b - 1) * cs) * 4

    per = MAX_THREADS // groups
    while per > 1 and smem(per) > MAX_SMEM:
        per -= 1
    assert smem(per) <= MAX_SMEM
    slices = -(-num_dy // per)
    dy = -(-num_dy // slices)
    return j, cs, dy, slices, max(MIN_THREADS, -(-groups * dy // 32) * 32)


def words(byte_rows):
    """(..., 4w) bytes -> (..., w) little-endian uint32 words as int64."""
    b = byte_rows.reshape(*byte_rows.shape[:-1], -1, 4).astype(np.int64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def packed_sad(a, b):
    """vabsdiff4.u32.u32.u32.add without the addend: the sum of the four
    bytes' absolute differences, from the two words."""
    return sum(np.abs(((a >> (8 * k)) & 0xFF) - ((b >> (8 * k)) & 0xFF)) for k in range(4))


def mirror(src, win, num_dy, num_dx):
    """The kernel's arithmetic: src (n, B, B), win (n, H, W) uint8 -> (n,
    num_dy, num_dx) int64."""
    n, b, _ = src.shape
    win_h, win_w = win.shape[1:]
    j_, cs, dy_per, slices, _ = plan(b, num_dy, num_dx)
    sw = b // 4
    out = np.full((n, num_dy, num_dx), -1, dtype=np.int64)
    s_words = words(src)                                          # (n, B, SW)
    for i in range(n):
        for sl in range(slices):
            dy0 = sl * dy_per
            rows = min(dy_per, num_dy - dy0)
            wrows = rows + b - 1
            # The window's words; bytes past the window are 0.
            raw = np.zeros((wrows, 4 * cs + 4), dtype=np.uint8)
            hh = max(0, min(wrows, win_h - dy0))
            ww = min(4 * cs + 4, win_w)
            raw[:hh, :ww] = win[i, dy0:dy0 + hh, :ww]
            row_words = words(raw)                                # (wrows, cs + 1)
            pair = row_words[:, :cs] | row_words[:, 1:] << 32
            copies = [((pair >> (8 * c)) & 0xFFFFFFFF) for c in range(CLASSES)]
            for cls in range(CLASSES):
                for g in range(class_groups(num_dx, cls, j_)):
                    j0 = g * j_
                    run = j0 + j_ + sw                            # one past the words read
                    assert run <= cs - 1, "a thread reads the copy's last word"
                    acc = np.zeros((rows, j_), dtype=np.int64)
                    for y in range(b):
                        seg = copies[cls][y:y + rows, j0:run]     # (rows, J + SW)
                        for xw in range(sw):
                            acc += packed_sad(seg[:, xw:xw + j_], s_words[i, y, xw])
                    for j in range(j_):
                        dx = cls + 4 * (j0 + j)
                        if dx < num_dx:
                            out[i, dy0:dy0 + rows, dx] = acc[:, j]
    assert (out >= 0).all(), "a candidate was not written"
    return out


@pytest.mark.parametrize("num", [1, 7, 17, 65])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_mirror_matches_jax_sad_grid(b, num):
    rng = np.random.default_rng(1000 * b + num)
    n, extra = 2, 3
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (n, b + num - 1 + extra, b + num - 1 + extra + 5), dtype=np.uint8)
    want = np.asarray(jax_sad_grid(jnp.asarray(src), jnp.asarray(win[:, :b + num - 1,
                                                                      :b + num - 1]), num, num))
    np.testing.assert_array_equal(mirror(src, win, num, num), want)


@pytest.mark.parametrize("b,num_dy,num_dx", [(16, 9, 33), (64, 3, 20), (8, 40, 5), (32, 65, 1)])
def test_mirror_matches_the_plain_version_off_the_square(b, num_dy, num_dx):
    rng = np.random.default_rng(b + num_dy + num_dx)
    src = rng.integers(0, 256, (3, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (3, b + num_dy - 1, b + num_dx - 1), dtype=np.uint8)
    want = sad_grid(src, win, num_dy, num_dx).numpy()
    np.testing.assert_array_equal(mirror(src, win, num_dy, num_dx), want)


@pytest.mark.parametrize("src_value,win_value", [(0, 255), (255, 0), (97, 97)])
def test_mirror_extremes_and_ties(src_value, win_value):
    src = np.full((2, 64, 64), src_value, dtype=np.uint8)
    win = np.full((2, 128, 128), win_value, dtype=np.uint8)
    got = mirror(src, win, 65, 65)
    assert int(got.min()) == int(got.max()) == 4096 * abs(src_value - win_value)


@pytest.mark.parametrize("b,num_dx", [(b, num) for b in (8, 16, 32, 64)
                                       for num in (1, 2, 3, 4, 5, 7, 17, 33, 65, 129, 256 - b + 1)
                                       if b + num - 1 <= 256])
def test_classes_cover_every_candidate_once(b, num_dx):
    j, cs, dy, slices, threads = plan(b, 65, num_dx)
    seen = [cls + 4 * (g * j + jj) for cls in range(CLASSES)
            for g in range(class_groups(num_dx, cls, j)) for jj in range(j)]
    assert sorted(dx for dx in seen if dx < num_dx) == list(range(num_dx))
    assert len(seen) - num_dx < 4 * j                        # idle slots: under one group a class
    assert threads <= MAX_THREADS and dy * slices >= 65
    # Vector loads stay aligned: 16-byte runs need J and B/4 multiples of 4.
    assert cs % 4 == 0 and (cs // 4) % 2 == 1


def test_plans_of_the_paths():
    # The full search and the PU decision at R = 32, and the pyramid's levels.
    assert [plan(b, 65, 65)[0] for b in (8, 16, 32, 64)] == [8, 4, 4, 4]
    assert plan(16, 17, 17)[0] == 4
    assert plan(64, 7, 7)[0] == 2
    # Instructions a 64 terms at B = 64, J = 4: 16 packed terms, the run's
    # 5 and the source row's 4 loads shared by 4 x 16 terms.
    sw, j = 16, 4
    per_row = j * sw + (j + sw) // 4 + sw // 4
    assert per_row / (j * sw * 4 / 64) <= 20
