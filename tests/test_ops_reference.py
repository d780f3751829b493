"""The plain XLA providers against brute-force float64 NumPy oracles: dense
data association (tpuslam.ops.association) and the landmark-Schur /
Cholesky solve (backend.gauss_newton.schur_solve)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuslam.backend import gauss_newton as gn
from tpuslam.ops import associate


def _oracle(obs, otype, lm, ltype, gate2, mode, cov_inv=None):
    """Per-observation loop over the map, in float64."""
    n = len(obs)
    idx = np.zeros(n, np.int64)
    hit = np.zeros(n, bool)
    for i in range(n):
        best, arg = np.inf, -1
        for j in range(len(lm)):
            d = obs[i] - lm[j]
            c = d @ cov_inv[j] @ d if cov_inv is not None else d @ d
            if ltype[j] != otype[i] or c >= gate2:
                continue
            if mode == "first":
                arg = j
                break
            if c < best:
                best, arg = c, j
        if arg >= 0:
            idx[i], hit[i] = arg, True
    return idx, hit


def _world(n_obs, n_lm, seed):
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-40, 40, (n_lm, 2))
    ltype = rng.integers(1, 4, n_lm)
    pick = rng.integers(0, n_lm, n_obs)
    obs = lm[pick] + rng.normal(0, 0.4, (n_obs, 2))
    otype = np.where(rng.random(n_obs) < 0.9, ltype[pick],
                     rng.integers(1, 4, n_obs))
    return obs, otype, lm, ltype


def _run(obs, otype, lm, ltype, gate, mode, cov_inv=None):
    idx, hit, _ = associate(
        jnp.asarray(obs, jnp.float32), jnp.asarray(otype, jnp.int32),
        jnp.ones(len(obs), bool), jnp.asarray(lm, jnp.float32),
        jnp.asarray(ltype, jnp.int32), jnp.ones(len(lm), bool), gate,
        mode=mode, lm_cov_inv=None if cov_inv is None
        else jnp.asarray(cov_inv, jnp.float32))
    return np.asarray(idx), np.asarray(hit)


@pytest.mark.parametrize("mode", ["first", "nearest"])
def test_association_euclidean_matches_oracle(mode):
    obs, otype, lm, ltype = _world(64, 200, seed=1)
    idx, hit = _run(obs, otype, lm, ltype, 1.2, mode)
    o_idx, o_hit = _oracle(obs, otype, lm, ltype, 1.44, mode)
    np.testing.assert_array_equal(hit, o_hit)
    np.testing.assert_array_equal(idx[hit], o_idx[o_hit])
    assert 0 < hit.sum() < len(hit)


def test_association_mahalanobis_matches_oracle():
    obs, otype, lm, ltype = _world(64, 200, seed=2)
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (len(lm), 2, 2))
    cov_inv = a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(2)
    idx, hit = _run(obs, otype, lm, ltype, 9.21, "mahalanobis", cov_inv)
    o_idx, o_hit = _oracle(obs, otype, lm, ltype, 9.21, "mahalanobis",
                           cov_inv)
    np.testing.assert_array_equal(hit, o_hit)
    np.testing.assert_array_equal(idx[hit], o_idx[o_hit])


def test_association_large_map_matches_oracle():
    """A 2,000-landmark map: the dense [N, L] matrix at the scale where a
    tiled kernel would first be considered."""
    obs, otype, lm, ltype = _world(256, 2000, seed=4)
    idx, hit = _run(obs, otype, lm, ltype, 1.2, "nearest")
    o_idx, o_hit = _oracle(obs, otype, lm, ltype, 1.44, "nearest")
    np.testing.assert_array_equal(hit, o_hit)
    np.testing.assert_array_equal(idx[hit], o_idx[o_hit])


def _schur_system(n, n_lm, seed):
    """A random SPD bundle system [[Hpp, W], [W^T, Hll]] with 2x2 landmark
    blocks, diagonally dominant so float32 keeps ~5 digits."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (n, 2 * n_lm)) / np.sqrt(n_lm)
    a = rng.normal(0, 1, (n, n)) / np.sqrt(n)
    hpp = a @ a.T + (2.0 * n_lm / n + 4.0) * np.eye(n)
    b = rng.normal(0, 1, (n_lm, 2, 2))
    hll = b @ np.swapaxes(b, 1, 2) + 2.0 * np.eye(2) \
        + np.eye(2) * (np.abs(w).sum(0).reshape(n_lm, 2).max(-1))[:, None,
                                                                  None]
    gp = rng.normal(0, 1, n)
    gl = rng.normal(0, 1, (n_lm, 2))
    return hpp, w, hll, gp, gl


@pytest.mark.parametrize("n", [64, 200, 384, 1024])
def test_schur_cholesky_solve_matches_float64(n):
    n_lm = 96
    hpp, w, hll, gp, gl = _schur_system(n, n_lm, seed=n)
    full = np.zeros((n + 2 * n_lm, n + 2 * n_lm))
    full[:n, :n] = hpp
    full[:n, n:] = w
    full[n:, :n] = w.T
    for j in range(n_lm):
        full[n + 2 * j:n + 2 * j + 2, n + 2 * j:n + 2 * j + 2] = hll[j]
    want = np.linalg.solve(full, -np.concatenate([gp, gl.reshape(-1)]))

    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        dp, dl = gn.schur_solve(f32(hpp), f32(w), f32(hll), f32(gp), f32(gl))
    got = np.concatenate([np.asarray(dp), np.asarray(dl).reshape(-1)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.gpu
def test_association_gpu_matches_cpu(gpu_device):
    obs, otype, lm, ltype = _world(512, 4096, seed=5)
    with jax.default_device(gpu_device):
        g_idx, g_hit = _run(obs, otype, lm, ltype, 1.2, "nearest")
    idx, hit = _run(obs, otype, lm, ltype, 1.2, "nearest")
    np.testing.assert_array_equal(g_hit, hit)
    np.testing.assert_array_equal(g_idx, idx)


@pytest.mark.gpu
def test_schur_solve_gpu_matches_cpu(gpu_device):
    sysm = [jnp.asarray(x, jnp.float32) for x in _schur_system(1536, 256, 6)]
    with jax.default_matmul_precision("highest"):
        cpu = gn.schur_solve(*sysm)
        gpu = gn.schur_solve(*jax.device_put(sysm, gpu_device))
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))
