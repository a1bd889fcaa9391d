"""Complex linear algebra via real 2n embedding vs direct
complex ops."""
import numpy as np
import jax.numpy as jnp
import pytest

from emme_tpu.ops import linalg


@pytest.fixture
def near_singular():
    rng = np.random.default_rng(0)
    n = 64
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = A + A.T  # complex symmetric like the physics operator
    u, s, vh = np.linalg.svd(A)
    s2 = s.copy()
    s2[-1] = 1e-10
    M = (u * s2) @ vh
    return M, np.conj(vh[-1])


def test_complex_solve_real_embedding_matches():
    rng = np.random.default_rng(1)
    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    C = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
    X1 = np.asarray(linalg.complex_solve(jnp.asarray(M), jnp.asarray(C)))
    X2 = np.asarray(linalg.complex_solve(jnp.asarray(M), jnp.asarray(C),
                                         force_real_embedding=True))
    assert np.abs(X1 - X2).max() < 1e-10
    assert np.abs(M @ X1 - C).max() < 1e-10


def test_complex_solve_trace_matches():
    rng = np.random.default_rng(2)
    n = 32
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    D = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    t1 = complex(linalg.complex_solve_trace(jnp.asarray(M), jnp.asarray(D)))
    t2 = complex(linalg.complex_solve_trace(jnp.asarray(M), jnp.asarray(D),
                                            force_real_embedding=True))
    t_np = np.trace(np.linalg.solve(M, D))
    assert abs(t1 - t_np) < 1e-9 * abs(t_np)
    assert abs(t2 - t_np) < 1e-9 * abs(t_np)


@pytest.mark.parametrize("method", ["svd", "inverse"])
def test_null_space_real_embedding(near_singular, method):
    M, v_true = near_singular
    v = np.asarray(linalg.null_space_vector(
        jnp.asarray(M), force_real_embedding=True, method=method))
    assert abs(np.vdot(v_true, v)) > 1 - 1e-8


def test_null_space_complex(near_singular):
    M, v_true = near_singular
    v = np.asarray(linalg.null_space_vector(jnp.asarray(M)))
    assert abs(np.vdot(v_true, v)) > 1 - 1e-8


def test_qr_column_pivoted_matches_scipy():
    # same pivot order and |R| as LAPACK's zgeqp3 (phases are convention);
    # reconstruction A[:, perm] = Q R to roundoff
    import scipy.linalg
    rng = np.random.default_rng(3)
    n = 48
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    Vr, Vi, tr, ti, Rr, Ri, perm = (np.asarray(x) for x in
                                    linalg.qr_column_pivoted(jnp.asarray(A)))
    Q_s, R_s, p_s = scipy.linalg.qr(A, pivoting=True)
    np.testing.assert_array_equal(perm, p_s)
    R = Rr + 1j * Ri
    np.testing.assert_allclose(np.abs(np.diag(R)), np.abs(np.diag(R_s)),
                               rtol=1e-10)
    assert np.allclose(np.triu(R), R, atol=1e-12)  # upper triangular
    # rebuild Q by applying the reflectors to the identity: Q = H_1...H_n I
    V = Vr + 1j * Vi
    tau = tr + 1j * ti
    Q = np.eye(n, dtype=complex)
    for k in range(n - 1, -1, -1):
        v = V[:, k]
        Q = Q - np.outer(tau[k] * v, np.conj(v) @ Q)
    np.testing.assert_allclose(Q @ R, A[:, perm], atol=1e-10)


def test_qr_secant_delta_matches_host_reference():
    # the update -R_nn / (Q^H dM v)_n computed with scipy's zgeqp3 must
    # match the device lax.scan implementation.  sigma_min = 1e-4 (not the
    # 1e-10 fixture): at rounding-level singularity the two QRs' R_nn values
    # are pure roundoff and legitimately differ.
    import scipy.linalg
    rng = np.random.default_rng(0)
    n = 64
    A = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    A = A + A.T
    u, s, vh = np.linalg.svd(A)
    s2 = s.copy()
    s2[-1] = 1e-4
    M = (u * s2) @ vh
    rng = np.random.default_rng(4)
    dM = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    dM = dM + dM.T

    got = complex(np.asarray(
        linalg.qr_secant_delta(jnp.asarray(M), jnp.asarray(dM))))

    Q, R, p = scipy.linalg.qr(M, pivoting=True)
    w = scipy.linalg.solve_triangular(R[:n - 1, :n - 1], R[:n - 1, n - 1])
    v = np.zeros(n, complex)
    v[p[:n - 1]] = -w
    v[p[n - 1]] = 1.0
    want = -R[n - 1, n - 1] / (np.conj(Q.T) @ (dM @ v))[n - 1]
    assert abs(got - want) / abs(want) < 1e-8
