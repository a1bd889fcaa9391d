// emme_native: multithreaded adaptive-quadrature assembly engine (C ABI).
//
// The CPU-exact counterpart of the device fixed-panel assembly: evaluates the
// gyrokinetic propagator kernel kappa_f_tau (see emme_tpu/ops/kernels.py and
// reference src/Parameters.cpp:113-209) with *adaptive* Gauss-Kronrod
// quadrature in f64, and fills the dense complex-symmetric operator in
// parallel.  Used for (a) fast self-validation goldens without the external
// reference binary and (b) a ~10x faster CPU f64 solve path than
// interpreted-precision JAX on hosts without accelerators.
//
// Parallelism: plain std::thread workers pulling (i, j) pair indices from a
// single atomic counter -- tasks are near-uniform so work stealing
// (reference include/DedicatedThreadPool.h) buys nothing here.
//
// Exposed C ABI (ctypes-friendly):
//   emme_kappa_batch(...)     -- batched kappa_f_tau (+ electron closed forms)
//   emme_assemble(...)        -- full electrostatic/electromagnetic assembly
//
// Build: see native/Makefile (g++ -std=c++20 -O3 -shared -fPIC).

#include <atomic>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

using cplx = std::complex<double>;
using namespace std::complex_literals;

namespace {

// ---------------------------------------------------------------------------
// Physics parameters (flat POD mirror of emme_tpu.params.Params)
// ---------------------------------------------------------------------------
struct Phys {
    double q, shat, tau, epsilon_n, epsilon_r, eta_i, eta_e, b_theta, beta_e;
    double R, vt, omega_d_coeff, length, theta, arc_coeff;
    double eta_k, lh, mh, epsilon_h_t, alpha_0, r_over_R;
    int32_t geometry;  // 0 tokamak, 1 stellarator, 2 cylinder,
                       // 3 cylinder-old, 4 taylor
    int32_t gk_order;              // 15 or 31
    double integration_rel_tol;    // global relative tolerance
    double precision_goal;         // absolute acceptance floor
    int32_t max_subdivide;         // recursion depth limit
    double cylinder_shat_coeff;    // precomputed on the Python side

    double alpha() const {
        return q * q * R * beta_e / (epsilon_n * R) *
               ((1 + eta_e) + 1 / tau * (1 + eta_i));
    }
    double omega_s_i() const {
        return -(std::sqrt(b_theta) * vt) / (epsilon_n * R);
    }
    double omega_s_e() const { return -tau * omega_s_i(); }
    double omega_d_bar() const {
        return 2.0 * epsilon_n * omega_s_i() * omega_d_coeff;
    }
};

// ---------------------------------------------------------------------------
// Geometry: g(eta) and b_i(eta) per model (physics identical to
// emme_tpu/geometry.py; see reference Parameters.cpp:76-100, 225-440)
// ---------------------------------------------------------------------------
double g_eta(const Phys& p, double eta) {
    const double a = p.alpha();
    switch (p.geometry) {
        case 0: {  // tokamak
            return -(a * eta) / 2.0 + p.shat * p.theta * std::cos(eta) -
                   p.shat * eta * std::cos(eta) + std::sin(eta) +
                   p.shat * std::sin(eta) + 0.25 * a * std::sin(2.0 * eta) -
                   (1.0 - p.shat) * p.q * p.epsilon_r /
                       (p.epsilon_r * p.epsilon_r + p.q * p.q) * eta;
        }
        case 1: {  // stellarator, regrouped with k = lh - mh q
            const double lh = p.lh, u = p.mh * p.q, k = lh - u, S = p.shat;
            const double E = p.epsilon_h_t;
            const double A = -0.25 * a;
            const double Rd = -a + (2.0 * S - 3.0) * A;
            const double curv =
                p.mh / p.lh * p.r_over_R / (p.q * p.R) * (4.0 - S) +
                (-a + 2.0 * S * A) / p.R;
            const double ARd = A * (1.0 + S) + Rd;
            const double ph = eta * k - p.alpha_0 * p.mh;
            const double km1 = k - 1.0, kp1 = k + 1.0, k2 = k * k;
            double num =
                eta * km1 * k2 * kp1 * (A + curv * p.R + Rd + A * S) -
                2.0 * E * (eta - p.eta_k) * lh * km1 * k * kp1 * S *
                    std::cos(ph) +
                2.0 * k2 * km1 * kp1 * (1.0 + S) * std::sin(eta) +
                std::cos(eta) *
                    (-2.0 * (eta - p.eta_k) * km1 * k2 * kp1 * S -
                     ((lh * lh * lh * lh - lh * lh) + (u * u * u * u - u * u)) *
                         ARd * std::sin(eta)) +
                std::sin(2.0 * eta) * ARd * lh * u *
                    (-1.0 + 2.0 * lh * lh - 3.0 * lh * u + 2.0 * u * u) +
                E * ARd * lh * k2 * (1.0 - k) * std::sin(eta + ph) -
                E * ARd * lh * k2 * (1.0 + k) * std::sin(eta - ph) -
                2.0 * E * lh * km1 * kp1 * (k + S) * std::sin(-ph);
            return num / (2.0 * km1 * k2 * kp1);
        }
        case 2:  // cylinder
            return eta * p.cylinder_shat_coeff;
        case 3:  // cylinder old
            return eta;
        default: {  // Taylor magnetic drift, Pade {3,4}
            const double S = p.shat;
            const double den_c = 7.0 + 16.0 * a + 40.0 * a * a - 28.0 * S -
                                 80.0 * a * S + 40.0 * S * S;
            const double e2 = eta * eta;
            const double num =
                eta + (e2 * eta *
                       (-31.0 - 96.0 * a - 168.0 * a * a - 560.0 * a * a * a +
                        186.0 * S + 672.0 * a * S + 1680.0 * a * a * S -
                        504.0 * S * S - 1680.0 * a * S * S + 560.0 * S * S * S)) /
                          (42.0 * den_c);
            const double den =
                1.0 +
                (e2 * (3.0 + 19.0 * a + 56.0 * a * a - 18.0 * S - 84.0 * a * S +
                       28.0 * S * S)) /
                    (7.0 * den_c) +
                (e2 * e2 * (11.0 - 4.0 * a + 704.0 * a * a - 88.0 * S -
                            584.0 * a * S + 216.0 * S * S)) /
                    (840.0 * den_c);
            return num / den;
        }
    }
}

double bi_eta(const Phys& p, double eta) {
    if (p.geometry == 1) {
        const double a = p.alpha();
        const double A = -0.25 * a;
        const double Rd = -a + (2.0 * p.shat - 3.0) * A;
        const double sigma = p.shat * (eta - p.eta_k) +
                             (A * (1.0 + p.shat) + Rd) * std::sin(eta);
        return p.b_theta * (1.0 + sigma * sigma);
    }
    const double a = p.alpha();
    const double s = p.shat * (eta - p.theta) - a * std::sin(eta);
    return p.b_theta * (1.0 + s * s);
}

// ---------------------------------------------------------------------------
// Scaled modified Bessel I0/I1 by Miller's backward-recurrence algorithm
// (DLMF 3.6(v)), formulated independently of the reference:
//   * reduce to the right half-plane Re w >= 0 via I0(-z) = I0(z),
//     I1(-z) = -I1(z) (the production path's reduction, ops/bessel.py);
//   * start the downward three-term recurrence y_{k-1} = (2k/w) y_k + y_{k+1}
//     at order N = |w| + C sqrt(|w|) + K (standard Miller start-order
//     heuristic; C, K sized for ~1e-16 relative convergence at order 1),
//     from the trial pair (y_N, y_{N+1}) = (1, 0), rescaling by 1/BIG
//     whenever |y| overflows the guard (instead of searching for a start
//     magnitude in a forward pass);
//   * normalize with the generating-function sum e^w = I0 + 2 sum_k I_k
//     (DLMF 10.35.1 at theta = 0), accumulated over ALL orders during the
//     descent, which directly yields the scaled values
//       i0s = I0(w) e^{-w} = y0 / S,   S = y0 + 2 sum_{k>=1} y_k.
// Returns i0s = I0(z) e^{zs}, i1s = I1(z) e^{zs}, zs = z (Re z < 0) else -z,
// so |e^{zs}| <= 1 and the caller folds -zs into its log-domain exponent.
// ---------------------------------------------------------------------------
struct BesselScaled {
    cplx i0s, i1s, zs;
};

BesselScaled bessel_i01(const cplx& z) {
    if (std::abs(z) == 0.0) return {1.0, 0.0, 0.0};
    const bool neg = std::real(z) < 0.0;
    const cplx zs = neg ? z : -z;
    const cplx w = neg ? -z : z;  // Re w >= 0
    const double aw = std::abs(w);
    const int N = static_cast<int>(aw + 9.0 * std::sqrt(aw)) + 24;
    constexpr double BIG = 1e250, INV_BIG = 1e-250;
    cplx yk1 = 0.0, yk = 1.0;          // y_{N+1}, y_N
    cplx s = 0.0;                       // 2 * sum_{k>=1} y_k (running)
    cplx y1 = 0.0;
    for (int k = N; k >= 1; --k) {
        const cplx ykm1 = (2.0 * k / w) * yk + yk1;
        s += 2.0 * yk;
        if (k == 1) y1 = yk;
        yk1 = yk;
        yk = ykm1;
        if (std::abs(yk) > BIG) {      // rescale guard: all quantities are
            yk *= INV_BIG;             // homogeneous in the trial scale
            yk1 *= INV_BIG;
            s *= INV_BIG;
            y1 *= INV_BIG;
        }
    }
    const cplx S = s + yk;             // e^w-normalization sum
    cplx i0 = yk / S;
    cplx i1 = y1 / S;
    if (neg) i1 = -i1;
    return {i0, i1, zs};
}

// ---------------------------------------------------------------------------
// Kernel integrand (physics of Parameters.cpp:120-176, organized around a
// per-pair context)
// ---------------------------------------------------------------------------
struct PairCtx {
    const Phys* p;
    int m;
    double eta, eta_p;
    cplx omega;
    double beta1, bie, bip, sqrt_bb, d_eta;
    double omi;

    PairCtx(const Phys& phys, int m_, double e, double ep, cplx om)
        : p(&phys), m(m_), eta(e), eta_p(ep), omega(om) {
        d_eta = eta - eta_p;
        beta1 = (phys.q * phys.R) / phys.vt * phys.omega_d_bar() *
                (g_eta(phys, eta) - g_eta(phys, eta_p));
        bie = bi_eta(phys, eta);
        bip = bi_eta(phys, eta_p);
        sqrt_bb = std::sqrt(bie * bip);
        omi = -std::copysign(1.0, std::real(om));
    }

    cplx operator()(double t) const {
        const Phys& ph = *p;
        const cplx ea = std::exp(-omi * 1.0i * std::atan(t / ph.arc_coeff));
        const cplx taut = t * ea;
        const cplx jac =
            ea - (1.0i * ea * omi * t) /
                     (ph.arc_coeff * (1.0 + (t / ph.arc_coeff) * (t / ph.arc_coeff)));
        const cplx lam = 1.0 + 0.5i * (taut * ph.vt) /
                                   (ph.q * ph.R * d_eta) * beta1;
        const auto bs = bessel_i01(sqrt_bb / lam);
        const cplx l3 = 1.0 / (lam * lam * lam);
        const cplx nv = (ph.q * ph.R * d_eta) / (ph.vt * taut);
        const double wsi = ph.omega_s_i();
        const cplx i0c =
            (omega - wsi * (1.0 + ph.eta_i * (0.5 * nv * nv - 1.5))) / lam +
            wsi * ph.eta_i * (0.5 * (bie + bip) - lam) * l3;
        const cplx i1c = -wsi * ph.eta_i * sqrt_bb * l3;
        const cplx lc = -0.5 * nv * nv - 0.5i * beta1 * nv +
                        1.0i * taut * omega -
                        (bie + bip) / (2.0 + 1.0i * beta1 / nv);
        const cplx expo = lc - bs.zs;
        if (std::real(expo) < -40.0) return 0.0;
        cplx nvm = 1.0;
        for (int k = 0; k < m; ++k) nvm *= nv;
        return nvm / taut * jac * std::exp(expo) *
               (i0c * bs.i0s + i1c * bs.i1s);
    }
};

// ---------------------------------------------------------------------------
// Adaptive Gauss-Kronrod over [0, pi/2] in x = atan(t) with an explicit
// interval stack (QUADPACK G7K15 / G15K31 node tables).
// ---------------------------------------------------------------------------
constexpr double K15_X[8] = {0.0, 0.20778495500789847, 0.40584515137739717,
                             0.58608723546769113, 0.74153118559939444,
                             0.86486442335976907, 0.94910791234275852,
                             0.99145537112081264};
constexpr double K15_WG[4] = {0.41795918367346939, 0.38183005050511894,
                              0.27970539148927667, 0.12948496616886969};
constexpr double K15_WK[8] = {
    2.09482141084727828e-01, 2.04432940075298892e-01, 1.90350578064785410e-01,
    1.69004726639267903e-01, 1.40653259715525919e-01, 1.04790010322250184e-01,
    6.30920926299785533e-02, 2.29353220105292250e-02};

constexpr double K31_X[16] = {
    0.0,
    0.1011420669187175,
    0.20119409399743452,
    0.29918000715316881,
    0.39415134707756337,
    0.48508186364023968,
    0.57097217260853885,
    0.65099674129741697,
    0.72441773136017005,
    0.79041850144246593,
    0.84820658341042722,
    0.8972645323440819,
    0.9372733924007059,
    0.96773907567913913,
    0.98799251802048543,
    0.99800229869339706};
constexpr double K31_WG[8] = {0.20257824192556112, 0.19843148532711152,
                              0.18616100001556193, 0.1662692058169939,
                              0.1395706779261542,  0.10715922046717143,
                              0.07036604748810768, 0.030753241996119};
constexpr double K31_WK[16] = {
    0.10133000701479155,   0.100769845523875595,  0.099173598721791959,
    0.0966427269836236785, 0.093126598170825321,  0.0885644430562117706,
    0.083080502823133021,  0.0768496807577203789, 0.069854121318728259,
    0.0620095678006706403, 0.053481524690928087,  0.0445897513247648766,
    0.035346360791375846,  0.0254608473267153202, 0.0150079473293161225,
    0.00537747987292334899};

template <int NH>
void gk_panel(const PairCtx& f, const double* X, const double* WK,
              const double* WG, int gauss_order, double mid, double half,
              cplx* integral, double* err) {
    // x-space node maps to t = tan(x); integrand includes the 1/cos^2 factor.
    auto eval = [&](double x) {
        const double c = std::cos(x);
        return f(std::tan(x)) / (c * c);
    };
    cplx gk = 0.0, g = 0.0;
    {
        const cplx f0 = eval(mid);
        gk += WK[0] * f0;
        if (gauss_order % 2) g += WG[0] * f0;
    }
    for (int i = 1; i < NH; ++i) {
        const cplx fv = eval(mid + half * X[i]) + eval(mid - half * X[i]);
        gk += WK[i] * fv;
        if ((gauss_order - i) % 2 != 0) g += WG[i / 2] * fv;
    }
    *integral = gk * half;
    *err = std::abs(gk - g) * half;
}

cplx integrate_adaptive(const PairCtx& f, const Phys& p) {
    struct Iv {
        double lo, hi;
    };
    std::vector<Iv> stack;
    stack.reserve(256);
    const double b = M_PI / 2.0;
    stack.push_back({0.0, b});
    cplx sum = 0.0;
    double abs_tol = 0.0;
    const double inv_scale = 2.0 / b;
    int guard = 0;
    while (!stack.empty() && ++guard < 100000) {
        const Iv iv = stack.back();
        stack.pop_back();
        const double mid = 0.5 * (iv.lo + iv.hi);
        const double half = 0.5 * (iv.hi - iv.lo);
        cplx integral;
        double err;
        if (p.gk_order == 31) {
            gk_panel<16>(f, K31_X, K31_WK, K31_WG, 15, mid, half, &integral,
                         &err);
        } else {
            gk_panel<8>(f, K15_X, K15_WK, K15_WG, 7, mid, half, &integral,
                        &err);
        }
        if (abs_tol == 0.0)
            abs_tol = std::abs(p.integration_rel_tol * integral);
        const bool can_split =
            std::ldexp(half, p.max_subdivide) > 0.99 * b;
        if (can_split && err > abs_tol * inv_scale + p.precision_goal &&
            err > std::abs(p.integration_rel_tol * integral) +
                      p.precision_goal) {
            stack.push_back({mid, iv.hi});
            stack.push_back({iv.lo, mid});
        } else {
            sum += integral;
        }
    }
    return sum;
}

cplx kappa_ion(const Phys& p, int m, double eta, double eta_p, cplx omega) {
    const PairCtx ctx(p, m, eta, eta_p, omega);
    const cplx result = integrate_adaptive(ctx, p);
    return -1.0i * (p.q * p.R) / (p.vt * std::sqrt(2.0 * M_PI)) * result;
}

cplx kappa_electron(const Phys& p, int m, double eta, double eta_p,
                    cplx omega) {
    const double d = eta - eta_p;
    const double sgn = d / std::abs(d);
    const double wse = p.omega_s_e();
    switch (m) {
        case 0:
            return 0.0;
        case 1:
            return -1.0i * (p.q * p.R) / (2.0 * p.vt * p.tau) *
                   (omega - wse) * sgn;
        default: {
            const double b1e = (p.q * p.R) / p.vt *
                               (p.omega_d_bar() * wse / p.omega_s_i()) *
                               (g_eta(p, eta) - g_eta(p, eta_p));
            return (p.q * p.q * p.R * p.R) / (2.0 * p.vt * p.vt * p.tau) *
                   sgn *
                   (omega * (omega - wse) * d -
                    b1e * p.vt / (p.q * p.R) *
                        (omega - wse * (1.0 + p.eta_e)));
        }
    }
}

void parallel_for(int64_t count, int n_threads,
                  const std::function<void(int64_t)>& fn) {
    if (n_threads <= 1) {
        for (int64_t i = 0; i < count; ++i) fn(i);
        return;
    }
    std::atomic<int64_t> next{0};
    std::vector<std::thread> ts;
    ts.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        ts.emplace_back([&] {
            for (;;) {
                const int64_t i = next.fetch_add(1);
                if (i >= count) break;
                fn(i);
            }
        });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// Batched kappa: out[k] = kappa_ion(m[k], eta[k], eta_p[k], omega) (+
// electron term when with_electron != 0).  out is interleaved re/im pairs.
void emme_kappa_batch(const Phys* p, const int32_t* m, const double* eta,
                      const double* eta_p, double omega_re, double omega_im,
                      int64_t count, int32_t with_electron, int32_t n_threads,
                      double* out) {
    const cplx omega(omega_re, omega_im);
    parallel_for(count, n_threads, [&](int64_t k) {
        cplx v = kappa_ion(*p, m[k], eta[k], eta_p[k], omega);
        if (with_electron)
            v += kappa_electron(*p, m[k], eta[k], eta_p[k], omega);
        out[2 * k] = std::real(v);
        out[2 * k + 1] = std::imag(v);
    });
}

// Full dense assembly (solver.h:417-515 semantics): out is a dim x dim
// row-major complex matrix as interleaved doubles, dim = npoints
// (electrostatic) or 2*npoints.  coeff is the npoints x npoints singularity
// coefficient matrix; grid spacing dx = 2 L / (npoints - 1).
void emme_assemble(const Phys* p, int32_t npoints, const double* coeff,
                   double omega_re, double omega_im, int32_t electromagnetic,
                   int32_t n_threads, double* out) {
    const cplx omega(omega_re, omega_im);
    const double dx = 2.0 * p->length / (npoints - 1);
    const int64_t n = npoints;
    const int64_t dim = electromagnetic ? 2 * n : n;
    auto at = [&](int64_t i, int64_t j) -> double* {
        return out + 2 * (i * dim + j);
    };
    auto put = [&](int64_t i, int64_t j, cplx v) {
        at(i, j)[0] = std::real(v);
        at(i, j)[1] = std::imag(v);
    };

    std::vector<double> grid(n);
    for (int64_t i = 0; i < n; ++i) grid[i] = -p->length + i * dx;

    const int64_t npairs = n * (n - 1) / 2;
    const cplx diag = 1.0 + 1.0 / p->tau;

    parallel_for(npairs, n_threads, [&](int64_t k) {
        // unrank upper-triangle pair k -> (i, j), i < j
        const int64_t i =
            n - 2 -
            static_cast<int64_t>(
                std::floor(std::sqrt(-8.0 * k + 4.0 * n * (n - 1) - 7) / 2.0 -
                           0.5));
        const int64_t j = k + i + 1 - n * (n - 1) / 2 + (n - i) * ((n - i) - 1) / 2;
        const double ei = grid[i], ej = grid[j];
        const cplx k0 = kappa_ion(*p, 0, ei, ej, omega);
        const cplx a = -k0 * coeff[i * n + j] * dx;
        put(i, j, a);
        put(j, i, a);
        if (electromagnetic) {
            const cplx k1 = kappa_ion(*p, 1, ei, ej, omega) +
                            kappa_electron(*p, 1, ei, ej, omega);
            const cplx k2 = kappa_ion(*p, 2, ei, ej, omega) +
                            kappa_electron(*p, 2, ei, ej, omega);
            const cplx u = k1 * dx, d = k2 * dx;
            put(i, j + n, u);
            put(j, i + n, -u);
            put(i + n, j, -u);
            put(j + n, i, u);
            put(i + n, j + n, d);
            put(j + n, i + n, d);
        }
    });

    for (int64_t i = 0; i < n; ++i) {
        put(i, i, diag);
        if (electromagnetic) {
            put(i, i + n, 0.0);
            put(i + n, i, 0.0);
            put(i + n, i + n, (2.0 * p->tau) / p->beta_e * bi_eta(*p, grid[i]));
        }
    }
}

// Scalar helpers exposed for validation
void emme_g_bi(const Phys* p, const double* eta, int64_t count, double* g_out,
               double* bi_out) {
    for (int64_t i = 0; i < count; ++i) {
        g_out[i] = g_eta(*p, eta[i]);
        bi_out[i] = bi_eta(*p, eta[i]);
    }
}

}  // extern "C"
