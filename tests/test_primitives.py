"""Unit tests for the scalar primitives (householder/givens/dlanv2/dlaqr1)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from starneig_jax.ops import primitives as prim

# jit all primitives once — eager dispatch of tiny ops is prohibitively slow
_householder = jax.jit(prim.householder)
_householder_masked = jax.jit(prim.householder)
_givens = jax.jit(prim.givens)
_eig2x2 = jax.jit(prim.eig2x2)
_standardize = jax.jit(prim.standardize_2x2)
_first_col = jax.jit(prim.first_column_shifted, static_argnums=())


RNG = np.random.default_rng(42)


class TestHouseholder:
    @pytest.mark.parametrize("m", [2, 3, 7, 64])
    def test_annihilates_tail(self, m):
        x = jnp.array(RNG.standard_normal(m))
        v, tau, beta = _householder(x)
        y = x - tau * v * (v @ x)
        np.testing.assert_allclose(np.asarray(y[0]), np.asarray(beta), rtol=1e-13)
        np.testing.assert_allclose(np.asarray(y[1:]), 0, atol=1e-13 * float(jnp.abs(beta)))

    def test_norm_preserved(self):
        x = jnp.array(RNG.standard_normal(16))
        _, _, beta = _householder(x)
        np.testing.assert_allclose(abs(float(beta)), float(jnp.linalg.norm(x)), rtol=1e-13)

    def test_masked(self):
        x = jnp.array(RNG.standard_normal(16))
        mask = jnp.arange(16) < 5
        v, tau, beta = _householder(x, mask)
        xm = jnp.where(mask, x, 0)
        y = xm - tau * v * (v @ xm)
        np.testing.assert_allclose(np.asarray(y[1:5]), 0, atol=1e-13)
        np.testing.assert_allclose(np.asarray(v[5:]), 0)
        np.testing.assert_allclose(abs(float(beta)), float(jnp.linalg.norm(xm)), rtol=1e-13)

    def test_zero_tail(self):
        x = jnp.array([3.0, 0.0, 0.0])
        v, tau, beta = _householder(x)
        assert float(tau) == 0.0
        assert float(beta) == 3.0

    def test_all_zero(self):
        x = jnp.zeros(4)
        v, tau, beta = _householder(x)
        assert np.isfinite(float(tau))
        assert float(beta) == 0.0


class TestGivens:
    @pytest.mark.parametrize("fg", [(3.0, 4.0), (-2.0, 1.0), (0.0, 5.0), (5.0, 0.0),
                                     (1e-30, 1e-30), (-3.0, -4.0)])
    def test_zeroes_g(self, fg):
        f, g = fg
        c, s, r = _givens(jnp.float64(f), jnp.float64(g))
        # rotation applied
        rf = c * f + s * g
        rg = -s * f + c * g
        np.testing.assert_allclose(float(rg), 0, atol=1e-14 * max(abs(f), abs(g), 1e-300))
        np.testing.assert_allclose(float(rf), float(r), rtol=1e-13)
        np.testing.assert_allclose(float(c * c + s * s), 1.0, rtol=1e-13)


class TestEig2x2:
    def test_real(self):
        a, b, c, d = 2.0, 1.0, 0.5, -1.0
        l1r, l1i, l2r, l2i = [float(v) for v in _eig2x2(*map(jnp.float64, (a, b, c, d)))]
        ev = np.sort(np.linalg.eigvals(np.array([[a, b], [c, d]])))
        np.testing.assert_allclose(sorted([l1r, l2r]), np.sort(ev.real), rtol=1e-12)
        assert l1i == 0 and l2i == 0

    def test_complex(self):
        a, b, c, d = 1.0, 2.0, -3.0, 1.5
        l1r, l1i, l2r, l2i = [float(v) for v in _eig2x2(*map(jnp.float64, (a, b, c, d)))]
        ev = np.linalg.eigvals(np.array([[a, b], [c, d]]))
        np.testing.assert_allclose(l1r, ev[0].real, rtol=1e-12)
        np.testing.assert_allclose(abs(l1i), abs(ev[0].imag), rtol=1e-12)
        assert l1i == -l2i


class TestStandardize2x2:
    def _check(self, a, b, c, d):
        out = _standardize(*[jnp.float64(v) for v in (a, b, c, d)])
        aa, bb, cc, dd, rt1r, rt1i, rt2r, rt2i, cs, sn = [float(v) for v in out]
        G = np.array([[cs, sn], [-sn, cs]])
        M = np.array([[a, b], [c, d]])
        R = G.T @ M @ G if False else None
        # NOTE convention: rotated = [cs sn; -sn cs]^T M [cs sn; -sn cs]
        R = np.array([[cs, -sn], [sn, cs]]).T @ M @ np.array([[cs, -sn], [sn, cs]])
        # accept either rotation handedness by testing the documented one:
        R = np.array([[cs, sn], [-sn, cs]]) @ M @ np.array([[cs, -sn], [sn, cs]])
        np.testing.assert_allclose(R, [[aa, bb], [cc, dd]], atol=1e-11 * (1 + np.abs(M).max()))
        # rotation is orthogonal
        np.testing.assert_allclose(cs * cs + sn * sn, 1.0, rtol=1e-12)
        # structure: either cc==0 (real) or aa==dd and bb*cc<0 (standard pair)
        if cc == 0.0:
            assert rt1i == 0.0
        else:
            np.testing.assert_allclose(aa, dd, rtol=1e-9, atol=1e-11)
            assert bb * cc < 0
        # eigenvalues preserved
        ev = np.sort_complex(np.linalg.eigvals(M))
        got = np.sort_complex(np.array([rt1r + 1j * rt1i, rt2r + 1j * rt2i]))
        np.testing.assert_allclose(got, ev, rtol=1e-9, atol=1e-11 * (1 + np.abs(ev).max()))

    def test_cases(self):
        cases = [
            (2.0, 1.0, 0.0, -1.0),      # already triangular
            (2.0, 0.0, 1.5, -1.0),      # b == 0
            (1.0, 3.0, -2.0, 1.0),      # a==d complex
            (1.0, 3.0, 2.0, 1.0),       # a==d real
            (4.0, 1.0, 0.5, -3.0),      # general real
            (1.0, 5.0, -3.0, 2.0),      # general complex
            (1.0, -5.0, 3.0, 2.0),      # general complex, flipped signs
            (0.0, 0.0, 0.0, 0.0),       # zero block
            (1e-8, 2e-8, -1e-8, 1.5e-8),  # tiny
        ]
        for case in cases:
            self._check(*case)

    def test_random_sweep(self):
        for i in range(200):
            m = RNG.standard_normal(4) * (10.0 ** RNG.integers(-3, 3))
            self._check(*m)


class TestFirstColumn:
    def test_real_shifts_3x3(self):
        H = jnp.array(RNG.standard_normal((3, 3)))
        s1, s2 = 0.7, -0.3
        v = _first_col(H, s1, 0.0, s2, 0.0, jnp.bool_(True))
        Hn = np.asarray(H)
        ref = ((Hn - s1 * np.eye(3)) @ (Hn - s2 * np.eye(3)))[:, 0]
        # v is a scaled version of ref
        ratio = np.asarray(v) / ref
        np.testing.assert_allclose(ratio, ratio[0], rtol=1e-12)

    def test_complex_pair_3x3(self):
        H = jnp.array(RNG.standard_normal((3, 3)))
        sr, si = 0.4, 1.1
        v = np.asarray(_first_col(H, sr, si, sr, -si, jnp.bool_(True)))
        Hn = np.asarray(H).astype(complex)
        M = (Hn - (sr + 1j * si) * np.eye(3)) @ (Hn - (sr - 1j * si) * np.eye(3))
        ref = M[:, 0].real
        ratio = v / ref
        np.testing.assert_allclose(ratio, ratio[0], rtol=1e-11)

    def test_2x2(self):
        H = jnp.array(RNG.standard_normal((3, 3)))
        s1, s2 = 0.2, 0.9
        v = np.asarray(_first_col(H, s1, 0.0, s2, 0.0, jnp.bool_(False)))
        Hn = np.asarray(H)[:2, :2]
        ref = ((Hn - s1 * np.eye(2)) @ (Hn - s2 * np.eye(2)))[:, 0]
        ratio = v[:2] / ref
        np.testing.assert_allclose(ratio, ratio[0], rtol=1e-12)
        assert v[2] == 0
