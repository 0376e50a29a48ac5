"""The port's min-plus EDT (plain PyTorch version) against the JAX
package's Pallas kernel (interpret mode) and XLA path, and the CUDA
kernel's lower-envelope algorithm (a numpy transcription of
``csrc/minplus.cu``, which cannot run without a card) against the plain
version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cluster_tools_tpu.ops import edt as jedt
from cluster_tools_tpu_torch.ops import edt as pedt

torch.set_num_threads(2)

# the shapes of the JAX package's Pallas test (n < 128, n not a multiple
# of 128, rows not a multiple of 16), the short z axis of a block, the
# shortest scanlines and the y/x scanline length of a block
SHAPES = [(13, 37), (4, 130), (20, 129), (331, 58), (3, 1), (5, 2),
          (6, 576)]


def _covered(p, hp, t, ht, q, hq):
    """t is not on the envelope of p < t < q (cross-multiplied, float64)."""
    return (hq - ht) * float(t - p) <= (ht - hp) * float(q - t)


def _advance(a, ha, b, hb, S, q):
    """The parabola at b is in use at q, not the one at a < b."""
    return hb - ha <= 2.0 * S * float(b - a) * float(q)


def _band_envelope(row, lo, hi, S):
    """The stack of one band [lo, hi): (position, f, h = f + S v^2)."""
    stack = []
    for q in range(lo, hi):
        fq = float(row[q])
        if not fq < pedt.BIG:
            continue
        hq = fq + S * float(q * q)
        while len(stack) >= 2 and _covered(stack[-2][0], stack[-2][2],
                                           stack[-1][0], stack[-1][2],
                                           q, hq):
            stack.pop()
        stack.append((q, fq, hq))
    return stack


def _envelope_np(f, s):
    """Test-only transcription of the kernel in ``csrc/minplus.cu`` along
    the rows of ``f``: the envelopes of the two bands of each scanline,
    merged at their bridge, each band's outputs walked from its first
    entry in use, with the same float64 cross-multiplied tests (Python
    floats are float64) and the same float32 output term."""
    f = np.asarray(f, np.float32)
    n = f.shape[1]
    nb = (n + 1) // 2
    s2 = np.float32(float(s) ** 2)
    S = float(s2)
    out = np.empty_like(f)
    for r, row in enumerate(f):
        A = _band_envelope(row, 0, nb, S)
        B = _band_envelope(row, nb, n, S)
        i, j = len(A) - 1, 0
        moved = bool(A and B)
        while moved:
            moved = False
            while i >= 1 and _covered(A[i - 1][0], A[i - 1][2], A[i][0],
                                      A[i][2], B[j][0], B[j][2]):
                i, moved = i - 1, True
            while j < len(B) - 1 and _covered(A[i][0], A[i][2], B[j][0],
                                              B[j][2], B[j + 1][0],
                                              B[j + 1][2]):
                j, moved = j + 1, True
        M = A[:i + 1] + B[j:]
        for lo, hi in ((0, nb), (nb, n)):
            if not M:
                out[r, lo:hi] = np.float32(pedt.BIG)
                continue
            k = 0
            if lo > 0:
                k = min(i + 1, len(M) - 1)
                while k > 0 and not _advance(M[k - 1][0], M[k - 1][2],
                                             M[k][0], M[k][2], S, lo):
                    k -= 1
                while k + 1 < len(M) and _advance(M[k][0], M[k][2],
                                                  M[k + 1][0], M[k + 1][2],
                                                  S, lo):
                    k += 1
            for q in range(lo, hi):
                while k + 1 < len(M) and _advance(M[k][0], M[k][2],
                                                  M[k + 1][0], M[k + 1][2],
                                                  S, q):
                    k += 1
                a, fa, _ = M[k]
                d = np.float32(q - a)
                out[r, q] = np.float32(fa) + (d * d) * s2
    return out


def _edt_envelope_np(mask, sampling):
    """The kernel path's EDT, in numpy: one envelope per axis, then the
    correctly rounded float32 sqrt."""
    dsq = np.where(mask, np.float32(pedt.BIG), np.float32(0))
    for ax in range(mask.ndim):
        xm = np.moveaxis(dsq, ax, -1)
        out = _envelope_np(xm.reshape(-1, xm.shape[-1]), sampling[ax])
        dsq = np.moveaxis(out.reshape(xm.shape), -1, ax)
    return np.sqrt(dsq.astype(np.float64)).astype(np.float32)


def _scanlines(m, n, seed):
    rng = np.random.RandomState(seed)
    f = (rng.rand(m, n) * 50).astype("float32")
    f[rng.rand(m, n) < 0.5] = pedt.BIG     # foreground at the EDT's BIG
    return f


@pytest.mark.parametrize("m,n", SHAPES)
def test_minplus_plain_unit_spacing_bitwise(m, n):
    """At unit spacing every candidate f + (i-j)^2 is one exact-cost f32
    add, so the plain version, the Pallas kernel and the XLA path agree
    bitwise."""
    f = _scanlines(m, n, seed=m + n)
    got = pedt.minplus_plain(torch.from_numpy(f), 1.0).numpy()
    pallas = np.asarray(jedt._minplus_pallas(jnp.asarray(f), 1.0,
                                             interpret=True))
    xla = np.asarray(jedt._minplus_axis(jnp.asarray(f), 1, 1.0))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(_envelope_np(f, 1.0), got)


@pytest.mark.parametrize("m,n", SHAPES)
def test_minplus_plain_anisotropic(m, n):
    """Anisotropic spacing.  Against the Pallas kernel (same cost formula
    (d*d)*s^2, which interpret mode contracts into one FMA with the add):
    rtol 1e-6, one float32 ulp.  Against the XLA path, which squares the
    difference of the rounded positions i*s and j*s: each position carries
    up to n*s*2^-24 of rounding, so its cost differs relatively by up to
    4*n*2^-24 from the exact-integer cost."""
    f = _scanlines(m, n, seed=2 * m + n)
    s = 0.7
    got = pedt.minplus_plain(torch.from_numpy(f), s).numpy()
    pallas = np.asarray(jedt._minplus_pallas(jnp.asarray(f), s,
                                             interpret=True))
    xla = np.asarray(jedt._minplus_axis(jnp.asarray(f), 1, s))
    np.testing.assert_allclose(got, pallas, rtol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=4 * n * 2.0 ** -24)
    np.testing.assert_allclose(_envelope_np(f, s), got, rtol=1e-6)


def _special_rows(n, seed):
    """Integer-valued scanlines (squared distances below 2^24, or BIG)
    with the envelope's corner cases: ties, all-BIG and all-zero rows, a
    single background voxel, BIG-heavy rows."""
    rng = np.random.RandomState(seed)
    rows = [np.full(n, pedt.BIG), np.zeros(n)]
    one = np.full(n, pedt.BIG)
    one[rng.randint(n)] = 0.0
    rows.append(one)
    if n > 1:
        edge = np.full(n, pedt.BIG)
        edge[-1] = 0.0
        rows.append(edge)
    for big_frac in (0.1, 0.5, 0.9):
        r = rng.randint(0, 40, n).astype(np.float64) ** 2
        r[rng.rand(n) < big_frac] = pedt.BIG
        rows.append(r)
    # ties: alternating values, a flat run, and three parabolas that meet
    # in one point (centres 0 and 2m at 0, centre m at m^2)
    ties = np.full(n, 9.0)
    ties[::2] = 1.0
    rows.append(ties)
    rows.append(np.full(n, 4.0))
    if n >= 3:
        m = (n - 1) // 2
        meet = np.full(n, pedt.BIG)
        meet[0], meet[m], meet[2 * m] = 0.0, float(m * m), 0.0
        rows.append(meet)
    rows.append(rng.randint(0, 2 ** 23, n).astype(np.float64))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 37, 130, 576])
def test_envelope_special_rows_bitwise(n):
    """The kernel's banded envelope (numpy transcription) equals the dense
    plain version bitwise on integer-valued rows at unit spacing, and
    within rtol 1e-6 at s = 0.7."""
    f = _special_rows(n, seed=n)
    plain = pedt.minplus_plain(torch.from_numpy(f), 1.0).numpy()
    np.testing.assert_array_equal(_envelope_np(f, 1.0), plain)
    plain = pedt.minplus_plain(torch.from_numpy(f), 0.7).numpy()
    np.testing.assert_allclose(_envelope_np(f, 0.7), plain, rtol=1e-6)


@pytest.mark.parametrize("shape,sampling", [
    ((24, 40, 36), None), ((17, 33, 29), None), ((12, 20, 18), (2.0, 1.0, 1.0)),
    ((12, 20, 18), (10.0, 1.0, 1.0)), ((9, 14, 11), (0.7, 0.7, 0.7))])
def test_distance_transform_edt_3d(shape, sampling):
    """3-d EDT of a random mask: bitwise equal to the JAX function at
    unit spacing (XLA's float32 sqrt is correctly rounded, and so is the
    port's); at anisotropic spacing rtol as for the XLA path above.  The
    kernel path's EDT (numpy transcription) equals the plain version
    bitwise at unit spacing and within rtol 1e-6 otherwise."""
    rng = np.random.RandomState(sum(shape))
    mask = rng.rand(*shape) > 0.15
    want = np.asarray(jedt.distance_transform_edt(jnp.asarray(mask),
                                                  sampling=sampling))
    got = pedt.distance_transform_edt(torch.from_numpy(mask),
                                      sampling=sampling).numpy()
    kernel = _edt_envelope_np(mask, sampling or (1.0,) * mask.ndim)
    if sampling is None:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(kernel, got)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * max(shape) * 2.0 ** -24)
        np.testing.assert_allclose(kernel, got, rtol=1e-6)


def test_minplus_dispatch_takes_plain_only_for_cpu_tensors():
    """A CPU tensor takes the plain version (no kernel launch is
    counted); the kernel wrapper refuses anything that is not on the
    card instead of falling back."""
    from cluster_tools_tpu_torch import kernels

    kernels.reset_counts()
    f = torch.from_numpy(_scanlines(8, 20, seed=1))
    np.testing.assert_array_equal(pedt.minplus(f, 1.0).numpy(),
                                  pedt.minplus_plain(f, 1.0).numpy())
    assert kernels.counts()["minplus"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        pedt.minplus_cuda(f, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pedt.minplus_axis_cuda(f > 10, 0, 1.0, sqrt=True)
