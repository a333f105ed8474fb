// Golden numerical-parity harness: an independent, reference-faithful
// implementation of the DSO sliding-window BA linearize/accumulate/solve
// chain and of the EDS event photometric cost, in double precision, driven
// by file I/O. tests/test_golden_parity.py seeds a world, runs this binary,
// and asserts that slam_eds_tpu.ops.energy (and ops.event_tracker) agree
// entry-wise within f32 tolerance — the only reference-parity proof
// available in an environment without the EDS dataset.
//
// Reference semantics implemented (all citations /root/reference/src/...):
//  * residual linearization: tracking/Residuals.cpp:69-265 — FEJ center
//    projection + analytic Jpdxi/Jpdc/Jpdd (with SCALE_F/SCALE_C/
//    SCALE_IDEPTH factors, tracking/HessianBlocks.h:58-66), per-pattern
//    current-state projection, bilinear sample of [I, gx, gy]
//    (getInterpolatedElement33, utils/globalFuncs.h), gradient + Huber
//    weighting, energy/outlier gating vs frameEnergyTH and wJI2 < 2.
//  * top-Hessian accumulation, mode 0: bundles/AccumulatedTopHessian.cpp:
//    39-162 — per-(host,target) 13x13 pair system [C(4) | xi+ab(8) | r].
//    The SSE AccumulatorApprox rank-updates (bundles/MatrixAccumulators.h:
//    595-980) compute the EXACT Gram of the factored jacobian, so this
//    harness sums the Gram directly in double (the 1/1k/1M cascade is a
//    float-precision device, not a semantic).
//  * adjoint transport: bundles/EnergyFunctional.cpp:46-106 (setAdjointsF,
//    incl. SCALE_A=10 / SCALE_B=1000 rows); stitch + symmetric completion:
//    bundles/AccumulatedTopHessian.cpp:166-280 (stitchDoubleInternal) with
//    the usePrior calib/frame prior terms.
//  * point Schur complement: bundles/AccumulatedSCHessian.cpp:34-180
//    (accHcc/accbc/accE/accEB/accD stitched through the adjoints), with
//    shiftPriorToZero (bdSum += prior*deltaF).
//  * solve: bundles/EnergyFunctional.cpp:775-913 (solveSystemF, default
//    solver mode path): HFinal = HA + HL(priors) (+HM=0), diagonal
//    *(1+lambda), minus H_sc/(1+lambda), SVecI = 1/sqrt(diag+10) scaling,
//    LDLT solve; back-substitution bundles/EnergyFunctional.cpp:263-317
//    (resubstituteFPt: step = -(bd - Hcd.xc - sum xAd.JpJdF) / Hdd, with
//    the UNdamped Hdd).
//  * event cost: tracking/PhotometricError.hpp:124-182 — interaction-matrix
//    flow, model = -grad.flow, 1e-3-seeded l2 normalization, 3D point from
//    norm_coord with idp+1e-5 guard, projection, Keys a=-0.5 bicubic
//    sampling with edge clamp (ceres::BiCubicInterpolator / Grid2D), and
//    the PhotometricErrorNC variant (PhotometricErrorNC.hpp:151-186)
//    normalizing the sampled event values.
//
// Usage:  dso_golden ba <input.bin> <output.bin>
//         dso_golden event <input.bin> <output.bin>
// Binary layout is described field-by-field in tests/test_golden_parity.py.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

using std::vector;

// ---------------------------------------------------------------------------
// minimal dense helpers (double)
struct Mat {
  int r = 0, c = 0;
  vector<double> a;
  Mat() {}
  Mat(int r_, int c_) : r(r_), c(c_), a((size_t)r_ * c_, 0.0) {}
  double& operator()(int i, int j) { return a[(size_t)i * c + j]; }
  double operator()(int i, int j) const { return a[(size_t)i * c + j]; }
};

Mat matmul(const Mat& A, const Mat& B, bool ta = false, bool tb = false) {
  int m = ta ? A.c : A.r, k = ta ? A.r : A.c, n = tb ? B.r : B.c;
  Mat C(m, n);
  for (int i = 0; i < m; i++)
    for (int l = 0; l < k; l++) {
      double av = ta ? A(l, i) : A(i, l);
      if (av == 0.0) continue;
      for (int j = 0; j < n; j++)
        C(i, j) += av * (tb ? B(j, l) : B(l, j));
    }
  return C;
}

// solve A x = b by LDLT (A symmetric, quasi-definite like Eigen ldlt use
// in EnergyFunctional.cpp:893); in-place on copies, no pivoting (the
// scaled system has diag ~1).
vector<double> ldlt_solve(Mat A, vector<double> b) {
  int n = A.r;
  vector<double> d(n, 0.0);
  for (int j = 0; j < n; j++) {
    double dj = A(j, j);
    for (int k = 0; k < j; k++) dj -= A(j, k) * A(j, k) * d[k];
    d[j] = dj;
    for (int i = j + 1; i < n; i++) {
      double v = A(i, j);
      for (int k = 0; k < j; k++) v -= A(i, k) * A(j, k) * d[k];
      A(i, j) = (std::fabs(dj) > 1e-300) ? v / dj : 0.0;
    }
  }
  // forward: L y = b
  for (int i = 0; i < n; i++)
    for (int k = 0; k < i; k++) b[i] -= A(i, k) * b[k];
  // diag
  for (int i = 0; i < n; i++) b[i] = (std::fabs(d[i]) > 1e-300) ? b[i] / d[i] : 0.0;
  // backward: L^T x = y
  for (int i = n - 1; i >= 0; i--)
    for (int k = i + 1; k < n; k++) b[i] -= A(k, i) * b[k];
  return b;
}

void skew(const double t[3], double S[3][3]) {
  S[0][0] = 0; S[0][1] = -t[2]; S[0][2] = t[1];
  S[1][0] = t[2]; S[1][1] = 0; S[1][2] = -t[0];
  S[2][0] = -t[1]; S[2][1] = t[0]; S[2][2] = 0;
}

// SE3 adjoint, tangent order (trans, rot): [[R, [t]x R], [0, R]]
// (sophus/se3.hpp Adj; same ordering as the d_xi jacobians)
void adj6(const double R[3][3], const double t[3], double A[6][6]) {
  double S[3][3]; skew(t, S);
  for (int i = 0; i < 6; i++) for (int j = 0; j < 6; j++) A[i][j] = 0;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      A[i][j] = R[i][j];
      A[3 + i][3 + j] = R[i][j];
      double v = 0;
      for (int k = 0; k < 3; k++) v += S[i][k] * R[k][j];
      A[i][3 + j] = v;
    }
}

struct Reader {
  FILE* f;
  explicit Reader(const char* p) { f = fopen(p, "rb"); }
  int32_t i32() { int32_t v; if (fread(&v, 4, 1, f) != 1) abort(); return v; }
  double f64() { double v; if (fread(&v, 8, 1, f) != 1) abort(); return v; }
  void arr(double* p, size_t n) { if (fread(p, 8, n, f) != n) abort(); }
  void arrf(float* p, size_t n) { if (fread(p, 4, n, f) != n) abort(); }
};
struct Writer {
  FILE* f;
  explicit Writer(const char* p) { f = fopen(p, "wb"); }
  void i32(int32_t v) { fwrite(&v, 4, 1, f); }
  void f64(double v) { fwrite(&v, 8, 1, f); }
  void arr(const double* p, size_t n) { fwrite(p, 8, n, f); }
};

// ---------------------------------------------------------------------------
// BA golden
constexpr int kPat = 8;
// DSO 8-point pattern (utils/settings.h:203-205 staticPattern[8])
constexpr int kPx[kPat] = {0, -1, 1, -2, 0, 2, -1, 0};
constexpr int kPy[kPat] = {-2, -1, -1, 0, 0, 0, 1, 2};
// SCALE constants (tracking/HessianBlocks.h:58-66)
constexpr double kScaleF = 1.0, kScaleC = 1.0, kScaleIdepth = 1.0;
constexpr double kScaleA = 10.0, kScaleB = 1000.0;

struct FrameIn {
  double R0[3][3], t0[3], Rc[3][3], tc[3];
  double aff0[2], affc[2], exposure;
  double prior[8], delta_prior[8], delta[8];
  double energy_th;
};
struct PointIn {
  double u, v, idepth, idepth_zero, prior;
  int host;
  double color[kPat], weights[kPat];
};

// bilinear on channel ch of [H, W, 3] float image (getInterpolatedElement33)
double interp3(const float* img, double x, double y, int W, int ch) {
  int ix = (int)std::floor(x), iy = (int)std::floor(y);
  double dx = x - ix, dy = y - iy;
  auto at = [&](int yy, int xx) { return (double)img[((size_t)yy * W + xx) * 3 + ch]; };
  return (1 - dx) * (1 - dy) * at(iy, ix) + dx * (1 - dy) * at(iy, ix + 1)
       + (1 - dx) * dy * at(iy + 1, ix) + dx * dy * at(iy + 1, ix + 1);
}

int run_ba(const char* inp, const char* outp) {
  Reader rd(inp);
  if (!rd.f) return 1;
  int F = rd.i32(), P = rd.i32(), K = rd.i32(), H = rd.i32(), W = rd.i32();
  int CP = rd.i32();
  if (K != kPat || CP != 4) return 2;
  double fx = rd.f64(), fy = rd.f64(), cx = rd.f64(), cy = rd.f64();
  double c_delta[4]; rd.arr(c_delta, 4);
  double lambda = rd.f64();
  double huber_th = rd.f64(), outlier_sum = rd.f64();
  int use_cprior = rd.i32();

  vector<FrameIn> fr(F);
  for (auto& f : fr) {
    rd.arr(&f.R0[0][0], 9); rd.arr(f.t0, 3);
    rd.arr(&f.Rc[0][0], 9); rd.arr(f.tc, 3);
    rd.arr(f.aff0, 2); rd.arr(f.affc, 2); f.exposure = rd.f64();
    rd.arr(f.prior, 8); rd.arr(f.delta_prior, 8); rd.arr(f.delta, 8);
    f.energy_th = rd.f64();
  }
  vector<PointIn> pt(P);
  for (auto& p : pt) {
    p.u = rd.f64(); p.v = rd.f64(); p.idepth = rd.f64();
    p.idepth_zero = rd.f64(); p.prior = rd.f64(); p.host = (int)rd.f64();
    rd.arr(p.color, kPat); rd.arr(p.weights, kPat);
  }
  vector<uint8_t> ract((size_t)P * F);
  if (fread(ract.data(), 1, ract.size(), rd.f) != ract.size()) return 3;
  vector<float> img((size_t)F * H * W * 3);
  rd.arrf(img.data(), img.size());
  fclose(rd.f);

  int D = CP + 8 * F;
  // --- pair precalc (FrameFramePrecalc::set, tracking/HessianBlocks.cpp):
  // FEJ relative R0/t0 for jacobians, current for pattern projection,
  // current-aff photometric mapping, FEJ b0.
  struct Pair {
    double R0[3][3], t0[3], Rc[3][3], tc[3];
    double a, b, b0;          // PRE_aff_mode, PRE_b0_mode
    double adH[8][8], adT[8][8];
  };
  vector<Pair> pairs((size_t)F * F);
  for (int h = 0; h < F; h++)
    for (int t = 0; t < F; t++) {
      Pair& q = pairs[(size_t)h * F + t];
      for (int i = 0; i < 3; i++) {
        for (int j = 0; j < 3; j++) {
          double v0 = 0, vc = 0;
          for (int k = 0; k < 3; k++) {
            v0 += fr[t].R0[i][k] * fr[h].R0[j][k];   // Rt * Rh^T
            vc += fr[t].Rc[i][k] * fr[h].Rc[j][k];
          }
          q.R0[i][j] = v0; q.Rc[i][j] = vc;
        }
      }
      for (int i = 0; i < 3; i++) {
        double v0 = fr[t].t0[i], vc = fr[t].tc[i];
        for (int k = 0; k < 3; k++) {
          v0 -= q.R0[i][k] * fr[h].t0[k];
          vc -= q.Rc[i][k] * fr[h].tc[k];
        }
        q.t0[i] = v0; q.tc[i] = vc;
      }
      // AffLight::fromToVecExposure (utils/NumType.h AffLight):
      // a = exp(a_t - a_h) * (e_t / e_h); b = b_t - a * b_h
      q.a = std::exp(fr[t].affc[0] - fr[h].affc[0])
            * (fr[t].exposure / fr[h].exposure);
      q.b = fr[t].affc[1] - q.a * fr[h].affc[1];
      q.b0 = fr[h].aff0[1];
      double a0 = std::exp(fr[t].aff0[0] - fr[h].aff0[0])
                  * (fr[t].exposure / fr[h].exposure);
      // setAdjointsF (EnergyFunctional.cpp:46-106): AH/AT with the FEJ
      // hostToTarget adjoint transpose and SCALE_* row scaling
      double A6[6][6]; adj6(q.R0, q.t0, A6);
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) { q.adH[i][j] = 0; q.adT[i][j] = 0; }
      for (int i = 0; i < 6; i++)
        for (int j = 0; j < 6; j++) {
          q.adH[i][j] = -A6[j][i];             // -Adj^T
          q.adT[i][j] = (i == j) ? 1.0 : 0.0;
        }
      q.adH[6][6] = a0; q.adH[7][7] = a0;
      q.adT[6][6] = -a0; q.adT[7][7] = -1.0;
      for (int i = 0; i < 8; i++) {
        double s = (i < 3) ? 1.0 /*SCALE_XI_TRANS*/ :
                   (i < 6) ? 1.0 /*SCALE_XI_ROT*/ :
                   (i == 6) ? kScaleA : kScaleB;
        for (int j = 0; j < 8; j++) { q.adH[i][j] *= s; q.adT[i][j] *= s; }
      }
    }

  // --- per-residual linearize (Residuals.cpp:69-265), mode-0 accumulation
  // into per-pair 13x13 systems [C(4) | rel(8) | r], plus per-point Schur
  // scalars and JpJdF vectors (EnergyFunctionalStructs.cpp takeDataF).
  vector<Mat> acc((size_t)F * F, Mat(13, 13));
  vector<int32_t> status((size_t)P * F, 3);   // 0 IN, 1 OOB, 2 OUTLIER, 3 off
  vector<double> resF((size_t)P * F * kPat, 0.0);
  vector<double> energyPF((size_t)P * F, 0.0);
  vector<double> Jout((size_t)P * F * (12 + 8 + 2 + 16), 0.0); // Jpdxi(12) Jpdc(8) Jpdd(2) JIdx(16)
  vector<double> Hdd(P, 0.0), bdv(P, 0.0);
  vector<double> Hcd((size_t)P * 4, 0.0);
  vector<double> JpJdF((size_t)P * F * 8, 0.0);

  for (int p = 0; p < P; p++) {
    const PointIn& pp = pt[p];
    for (int t = 0; t < F; t++) {
      if (t == pp.host || !ract[(size_t)p * F + t]) continue;
      const Pair& pr = pairs[(size_t)pp.host * F + t];
      // FEJ center projection (projectPoint with idepth_zero,
      // ResidualProjections.h:59-86)
      double KliP[3] = {(pp.u - cx) / fx, (pp.v - cy) / fy, 1.0};
      double ptp[3];
      for (int i = 0; i < 3; i++) {
        ptp[i] = pr.t0[i] * pp.idepth_zero;
        for (int k = 0; k < 3; k++) ptp[i] += pr.R0[i][k] * KliP[k];
      }
      double drescale = 1.0 / ptp[2];
      if (!(drescale > 0)) { status[(size_t)p * F + t] = 1; continue; }
      double u = ptp[0] * drescale, v = ptp[1] * drescale;
      double Ku = u * fx + cx, Kv = v * fy + cy;
      double new_idepth = pp.idepth_zero * drescale;
      if (!(Ku > 1.1 && Kv > 1.1 && Ku < W - 3 && Kv < H - 3)) {
        status[(size_t)p * F + t] = 1; continue;
      }
      // geometric jacobians (Residuals.cpp:105-149)
      double d_d[2] = {
          drescale * (pr.t0[0] - pr.t0[2] * u) * kScaleIdepth * fx,
          drescale * (pr.t0[1] - pr.t0[2] * v) * kScaleIdepth * fy};
      double dCx[4], dCy[4];
      dCx[2] = drescale * (pr.R0[2][0] * u - pr.R0[0][0]);
      dCx[3] = fx * drescale * (pr.R0[2][1] * u - pr.R0[0][1]) / fy;
      dCx[0] = KliP[0] * dCx[2];
      dCx[1] = KliP[1] * dCx[3];
      dCy[2] = fy * drescale * (pr.R0[2][0] * v - pr.R0[1][0]) / fx;
      dCy[3] = drescale * (pr.R0[2][1] * v - pr.R0[1][1]);
      dCy[0] = KliP[0] * dCy[2];
      dCy[1] = KliP[1] * dCy[3];
      dCx[0] = (dCx[0] + u) * kScaleF; dCx[1] *= kScaleF;
      dCx[2] = (dCx[2] + 1) * kScaleC; dCx[3] *= kScaleC;
      dCy[0] *= kScaleF; dCy[1] = (dCy[1] + v) * kScaleF;
      dCy[2] *= kScaleC; dCy[3] = (dCy[3] + 1) * kScaleC;
      double dxix[6] = {new_idepth * fx, 0, -new_idepth * u * fx,
                        -u * v * fx, (1 + u * u) * fx, -v * fx};
      double dxiy[6] = {0, new_idepth * fy, -new_idepth * v * fy,
                        -(1 + v * v) * fy, u * v * fy, u * fy};

      // pattern loop at the current state (Residuals.cpp:174-236)
      double rF[kPat], JI[2][kPat], Jab[2][kPat];
      double JI2[2][2] = {{0, 0}, {0, 0}}, JabJI[2][2] = {{0, 0}, {0, 0}};
      double Jab2[2][2] = {{0, 0}, {0, 0}};
      double energy = 0, wJI2 = 0;
      bool oob = false;
      const float* di = &img[(size_t)t * H * W * 3];
      for (int k = 0; k < kPat && !oob; k++) {
        double pu = pp.u + kPx[k], pv = pp.v + kPy[k];
        double kl[3] = {(pu - cx) / fx, (pv - cy) / fy, 1.0};
        double pc[3];
        for (int i = 0; i < 3; i++) {
          pc[i] = pr.tc[i] * pp.idepth;
          for (int kk = 0; kk < 3; kk++) pc[i] += pr.Rc[i][kk] * kl[kk];
        }
        double Kup = (pc[0] / pc[2]) * fx + cx, Kvp = (pc[1] / pc[2]) * fy + cy;
        if (!(pc[2] > 0 && Kup > 1.1 && Kvp > 1.1 && Kup < W - 3 && Kvp < H - 3)) {
          oob = true; break;
        }
        double hit = interp3(di, Kup, Kvp, W, 0);
        double gxv = interp3(di, Kup, Kvp, W, 1);
        double gyv = interp3(di, Kup, Kvp, W, 2);
        if (!std::isfinite(hit)) { oob = true; break; }
        double residual = hit - (pr.a * pp.color[k] + pr.b);
        double drdA = pp.color[k] - pr.b0;
        double w = std::sqrt(outlier_sum / (outlier_sum + gxv * gxv + gyv * gyv));
        w = 0.5 * (w + pp.weights[k]);
        double hw = std::fabs(residual) < huber_th ? 1.0 : huber_th / std::fabs(residual);
        energy += w * w * hw * residual * residual * (2 - hw);
        if (hw < 1) hw = std::sqrt(hw);
        hw *= w;
        double gx = gxv * hw, gy = gyv * hw;
        rF[k] = residual * hw;
        JI[0][k] = gx; JI[1][k] = gy;
        Jab[0][k] = drdA * hw; Jab[1][k] = hw;
        JI2[0][0] += gx * gx; JI2[1][1] += gy * gy; JI2[0][1] += gx * gy;
        JabJI[0][0] += drdA * hw * gx; JabJI[0][1] += drdA * hw * gy;
        JabJI[1][0] += hw * gx; JabJI[1][1] += hw * gy;
        Jab2[0][0] += drdA * drdA * hw * hw; Jab2[0][1] += drdA * hw * hw;
        Jab2[1][1] += hw * hw;
      }
      if (oob) { status[(size_t)p * F + t] = 1; continue; }
      JI2[1][0] = JI2[0][1]; Jab2[1][0] = Jab2[0][1];
      // recompute wJI2 cleanly (hw already includes w)
      wJI2 = 0;
      for (int k = 0; k < kPat; k++)
        wJI2 += JI[0][k] * JI[0][k] + JI[1][k] * JI[1][k];
      energyPF[(size_t)p * F + t] = energy;
      double th = std::max(fr[pp.host].energy_th, fr[t].energy_th);
      if (energy > th || wJI2 < 2) { status[(size_t)p * F + t] = 2; continue; }
      status[(size_t)p * F + t] = 0;

      // dump per-residual jacobians
      double* J = &Jout[(size_t)(p * F + t) * 38];
      for (int i = 0; i < 6; i++) { J[i] = dxix[i]; J[6 + i] = dxiy[i]; }
      for (int i = 0; i < 4; i++) { J[12 + i] = dCx[i]; J[16 + i] = dCy[i]; }
      J[20] = d_d[0]; J[21] = d_d[1];
      for (int k = 0; k < kPat; k++) { J[22 + k] = JI[0][k]; J[30 + k] = JI[1][k]; }
      for (int k = 0; k < kPat; k++) resF[(size_t)(p * F + t) * kPat + k] = rF[k];

      // mode-0 accumulation (AccumulatedTopHessian.cpp:104-140): pair
      // 13x13 += Gram of the factored per-pixel jacobian
      // [Jpdc(4) | JI.Jpdxi+Jab rows(8) | res].
      Mat& A = acc[(size_t)pp.host * F + t];
      double JIr[2] = {0, 0}, Jabr[2] = {0, 0}, rr = 0;
      for (int k = 0; k < kPat; k++) {
        JIr[0] += rF[k] * JI[0][k]; JIr[1] += rF[k] * JI[1][k];
        Jabr[0] += rF[k] * Jab[0][k]; Jabr[1] += rF[k] * Jab[1][k];
        rr += rF[k] * rF[k];
      }
      // 13-vector basis per geometric row g in {x, y}: the pair system is
      // sum over pixels of outer([Jpdc_g | Jpdxi_g | a/b | r]-factored).
      // Equivalent closed form using the 2x2 inner products:
      double X[2][13];   // rows: geometric factor per image axis
      for (int g = 0; g < 2; g++) {
        const double* dc = g == 0 ? dCx : dCy;
        const double* dxi = g == 0 ? dxix : dxiy;
        for (int i = 0; i < 4; i++) X[g][i] = dc[i];
        for (int i = 0; i < 6; i++) X[g][4 + i] = dxi[i];
        X[g][10] = 0; X[g][11] = 0; X[g][12] = 0;
      }
      // top-left 10x10: X^T JI2 X
      for (int i = 0; i < 10; i++)
        for (int j = 0; j < 10; j++) {
          double s = 0;
          for (int g1 = 0; g1 < 2; g1++)
            for (int g2 = 0; g2 < 2; g2++)
              s += X[g1][i] * JI2[g1][g2] * X[g2][j];
          A(i, j) += s;
        }
      // top-right 10 x [a, b, r]
      for (int i = 0; i < 10; i++) {
        double sa = 0, sb = 0, sr = 0;
        for (int g = 0; g < 2; g++) {
          sa += X[g][i] * JabJI[0][g];
          sb += X[g][i] * JabJI[1][g];
          sr += X[g][i] * JIr[g];
        }
        A(i, 10) += sa; A(i, 11) += sb; A(i, 12) += sr;
        A(10, i) += sa; A(11, i) += sb; A(12, i) += sr;
      }
      // bottom-right 3x3 [a, b, r]
      A(10, 10) += Jab2[0][0]; A(10, 11) += Jab2[0][1]; A(11, 10) += Jab2[0][1];
      A(11, 11) += Jab2[1][1];
      A(10, 12) += Jabr[0]; A(12, 10) += Jabr[0];
      A(11, 12) += Jabr[1]; A(12, 11) += Jabr[1];
      A(12, 12) += rr;

      // per-point Schur scalars (AccumulatedTopHessian.cpp:132-135)
      double JiJd[2] = {JI2[0][0] * d_d[0] + JI2[0][1] * d_d[1],
                        JI2[1][0] * d_d[0] + JI2[1][1] * d_d[1]};
      bdv[p] += JIr[0] * d_d[0] + JIr[1] * d_d[1];
      Hdd[p] += JiJd[0] * d_d[0] + JiJd[1] * d_d[1];
      for (int i = 0; i < 4; i++)
        Hcd[(size_t)p * 4 + i] += dCx[i] * JiJd[0] + dCy[i] * JiJd[1];
      // JpJdF (EnergyFunctionalStructs.cpp:38-48)
      double* jp = &JpJdF[(size_t)(p * F + t) * 8];
      for (int i = 0; i < 6; i++) jp[i] = dxix[i] * JiJd[0] + dxiy[i] * JiJd[1];
      jp[6] = JabJI[0][0] * d_d[0] + JabJI[0][1] * d_d[1];
      jp[7] = JabJI[1][0] * d_d[0] + JabJI[1][1] * d_d[1];
    }
  }

  // --- stitch the active system (stitchDoubleInternal + symmetric copy)
  Mat HA(D, D); vector<double> bA(D, 0.0);
  for (int h = 0; h < F; h++)
    for (int t = 0; t < F; t++) {
      const Mat& A = acc[(size_t)h * F + t];
      const Pair& pr = pairs[(size_t)h * F + t];
      int hI = CP + 8 * h, tI = CP + 8 * t;
      // adH/adT act on the rel(8) block rows 4..11 of the pair system
      double AH8[8][13], AT8[8][13];
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 13; j++) {
          double sh = 0, st = 0;
          for (int k = 0; k < 8; k++) {
            // rel-block rows/cols 4..9 are xi, 10..11 are a/b
            int col = 4 + k;                     // 4..9, 10, 11
            sh += pr.adH[i][k] * A(col, j);
            st += pr.adT[i][k] * A(col, j);
          }
          AH8[i][j] = sh; AT8[i][j] = st;
        }
      auto relcol = [](int k) { return 4 + k; };
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          double hh = 0, tt = 0, ht = 0;
          for (int k = 0; k < 8; k++) {
            hh += AH8[i][relcol(k)] * pr.adH[j][k];
            tt += AT8[i][relcol(k)] * pr.adT[j][k];
            ht += AH8[i][relcol(k)] * pr.adT[j][k];
          }
          HA(hI + i, hI + j) += hh;
          HA(tI + i, tI + j) += tt;
          HA(hI + i, tI + j) += ht;
        }
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++) {
          HA(hI + i, j) += AH8[i][j];
          HA(tI + i, j) += AT8[i][j];
        }
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) HA(i, j) += A(i, j);
      for (int i = 0; i < 8; i++) {
        bA[hI + i] += AH8[i][12];
        bA[tI + i] += AT8[i][12];
      }
      for (int i = 0; i < 4; i++) bA[i] += A(i, 12);
    }
  // symmetric completion (stitchDoubleMT tail)
  for (int h = 0; h < F; h++) {
    int hI = CP + 8 * h;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 8; j++) HA(i, hI + j) = HA(hI + j, i);
    for (int t = h + 1; t < F; t++) {
      int tI = CP + 8 * t;
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          double s = HA(hI + i, tI + j) + HA(tI + j, hI + i);
          HA(hI + i, tI + j) = s;
          HA(tI + j, hI + i) = s;
        }
    }
  }

  // --- priors (the L pass contributes only these here: no linearized
  // residuals; stitchDoubleInternal usePrior branch)
  Mat HP(D, D); vector<double> bP(D, 0.0);
  if (use_cprior) {
    for (int i = 0; i < 4; i++) {
      HP(i, i) += 5e9;                       // setting_initialCalibHessian
      bP[i] += 5e9 * c_delta[i];
    }
  }
  for (int h = 0; h < F; h++)
    for (int i = 0; i < 8; i++) {
      HP(CP + 8 * h + i, CP + 8 * h + i) += fr[h].prior[i];
      bP[CP + 8 * h + i] += fr[h].prior[i] * fr[h].delta_prior[i];
    }

  // --- point Schur complement (AccumulatedSCHessian::addPoint + stitch)
  Mat Hsc(D, D); vector<double> bsc(D, 0.0);
  vector<double> HdiF(P, 0.0), bdSum(P, 0.0);
  for (int p = 0; p < P; p++) {
    int ngood = 0;
    for (int t = 0; t < F; t++) if (status[(size_t)p * F + t] == 0) ngood++;
    if (ngood == 0) continue;
    double Hp = Hdd[p] + pt[p].prior;
    if (Hp < 1e-10) Hp = 1e-10;
    HdiF[p] = 1.0 / Hp;
    bdSum[p] = bdv[p] + pt[p].prior * (pt[p].idepth - pt[p].idepth_zero);
    // accHcc / accbc
    for (int i = 0; i < 4; i++) {
      for (int j = 0; j < 4; j++)
        Hsc(i, j) += Hcd[(size_t)p * 4 + i] * Hcd[(size_t)p * 4 + j] * HdiF[p];
      bsc[i] += Hcd[(size_t)p * 4 + i] * bdSum[p] * HdiF[p];
    }
    for (int t1 = 0; t1 < F; t1++) {
      if (status[(size_t)p * F + t1] != 0) continue;
      int h = pt[p].host;
      const Pair& pr1 = pairs[(size_t)h * F + t1];
      const double* j1 = &JpJdF[(size_t)(p * F + t1) * 8];
      int hI = CP + 8 * h, t1I = CP + 8 * t1;
      // accE/accEB: JpJdF x Hcd, JpJdF * bdSum
      for (int i = 0; i < 8; i++) {
        double vh = 0, vt = 0;
        for (int k = 0; k < 8; k++) {
          vh += pr1.adH[i][k] * j1[k];
          vt += pr1.adT[i][k] * j1[k];
        }
        for (int j = 0; j < 4; j++) {
          Hsc(hI + i, j) += vh * Hcd[(size_t)p * 4 + j] * HdiF[p];
          Hsc(t1I + i, j) += vt * Hcd[(size_t)p * 4 + j] * HdiF[p];
        }
        bsc[hI + i] += vh * bdSum[p] * HdiF[p];
        bsc[t1I + i] += vt * bdSum[p] * HdiF[p];
      }
      // accD triples
      for (int t2 = 0; t2 < F; t2++) {
        if (status[(size_t)p * F + t2] != 0) continue;
        const Pair& pr2 = pairs[(size_t)h * F + t2];
        const double* j2 = &JpJdF[(size_t)(p * F + t2) * 8];
        int t2I = CP + 8 * t2;
        for (int i = 0; i < 8; i++) {
          double v1h = 0, v1t = 0;
          for (int k = 0; k < 8; k++) {
            v1h += pr1.adH[i][k] * j1[k];
            v1t += pr1.adT[i][k] * j1[k];
          }
          for (int j = 0; j < 8; j++) {
            double v2h = 0, v2t = 0;
            for (int k = 0; k < 8; k++) {
              v2h += pr2.adH[j][k] * j2[k];
              v2t += pr2.adT[j][k] * j2[k];
            }
            Hsc(hI + i, hI + j) += v1h * v2h * HdiF[p];
            Hsc(t1I + i, t2I + j) += v1t * v2t * HdiF[p];
            Hsc(t1I + i, hI + j) += v1t * v2h * HdiF[p];
            Hsc(hI + i, t2I + j) += v1h * v2t * HdiF[p];
          }
        }
      }
    }
  }
  // SC symmetric completion: the reference's SC stitch fills the lower
  // frame-block triangle and calib column; solveSystemF consumes it after
  // the same transposed-copy pass as the top Hessian. Note accD covers
  // all (t1, t2) pairs here so frame blocks are already symmetric; only
  // the calib row/col needs mirroring.
  for (int i = 4; i < D; i++)
    for (int j = 0; j < 4; j++) Hsc(j, i) = Hsc(i, j);

  // --- solveSystemF default path: HFinal = HA + priors; *(1+lambda) diag;
  // -= Hsc/(1+lambda); SVecI scaled LDLT
  Mat HF(D, D); vector<double> bF(D, 0.0);
  for (int i = 0; i < D; i++) {
    for (int j = 0; j < D; j++) HF(i, j) = HA(i, j) + HP(i, j);
    bF[i] = bA[i] + bP[i] - bsc[i];
  }
  for (int i = 0; i < D; i++) HF(i, i) *= (1 + lambda);
  for (int i = 0; i < D; i++)
    for (int j = 0; j < D; j++) HF(i, j) -= Hsc(i, j) / (1 + lambda);

  vector<double> svecI(D);
  for (int i = 0; i < D; i++) svecI[i] = 1.0 / std::sqrt(HF(i, i) + 10.0);
  Mat Hs(D, D); vector<double> bs(D, 0.0);
  for (int i = 0; i < D; i++) {
    for (int j = 0; j < D; j++) Hs(i, j) = HF(i, j) * svecI[i] * svecI[j];
    bs[i] = bF[i] * svecI[i];
  }
  vector<double> xs = ldlt_solve(Hs, bs);
  vector<double> x(D);
  for (int i = 0; i < D; i++) x[i] = xs[i] * svecI[i];

  // --- resubstitution (EnergyFunctional.cpp:263-317): xAd per (h,t) pair,
  // step = -(bdSum - xc.Hcd - sum xAd.JpJdF) * HdiF
  vector<double> steps(P, 0.0);
  for (int p = 0; p < P; p++) {
    int ngood = 0;
    for (int t = 0; t < F; t++) if (status[(size_t)p * F + t] == 0) ngood++;
    if (ngood == 0) continue;
    double b = bdSum[p];
    for (int i = 0; i < 4; i++) b -= x[i] * Hcd[(size_t)p * 4 + i];
    int h = pt[p].host;
    for (int t = 0; t < F; t++) {
      if (status[(size_t)p * F + t] != 0) continue;
      const Pair& pr = pairs[(size_t)h * F + t];
      const double* jp = &JpJdF[(size_t)(p * F + t) * 8];
      double xad = 0;
      for (int i = 0; i < 8; i++) {
        double v = 0;
        for (int k = 0; k < 8; k++)
          v += x[CP + 8 * h + k] * pr.adH[k][i] + x[CP + 8 * t + k] * pr.adT[k][i];
        xad += v * jp[i];
      }
      b -= xad;
    }
    steps[p] = -b * HdiF[p];
  }

  // --- outputs
  Writer wr(outp);
  if (!wr.f) return 4;
  wr.i32(D); wr.i32(P); wr.i32(F);
  wr.arr(HA.a.data(), HA.a.size()); wr.arr(bA.data(), D);
  wr.arr(Hsc.a.data(), Hsc.a.size()); wr.arr(bsc.data(), D);
  wr.arr(HF.a.data(), HF.a.size()); wr.arr(bF.data(), D);
  wr.arr(x.data(), D);
  wr.arr(steps.data(), P);
  wr.arr(Hdd.data(), P); wr.arr(bdv.data(), P);
  for (size_t i = 0; i < status.size(); i++) wr.f64((double)status[i]);
  wr.arr(energyPF.data(), energyPF.size());
  wr.arr(resF.data(), resF.size());
  wr.arr(Jout.data(), Jout.size());
  fclose(wr.f);
  return 0;
}

// ---------------------------------------------------------------------------
// Event cost golden (PhotometricError.hpp:124-182 / PhotometricErrorNC)

// Keys a=-0.5 cubic weights — the ceres::BiCubicInterpolator kernel
void cubic_w(double t, double w[4]) {
  double t2 = t * t, t3 = t2 * t;
  w[0] = -0.5 * t3 + t2 - 0.5 * t;
  w[1] = 1.5 * t3 - 2.5 * t2 + 1.0;
  w[2] = -1.5 * t3 + 2.0 * t2 + 0.5 * t;
  w[3] = 0.5 * t3 - 0.5 * t2;
}

double bicubic(const vector<double>& img, int H, int W, double x, double y) {
  int ix = (int)std::floor(x), iy = (int)std::floor(y);
  double wx[4], wy[4];
  cubic_w(x - ix, wx); cubic_w(y - iy, wy);
  double v = 0;
  for (int r = 0; r < 4; r++) {
    int yy = iy - 1 + r;
    yy = yy < 0 ? 0 : (yy > H - 1 ? H - 1 : yy);   // Grid2D edge clamp
    double row = 0;
    for (int c = 0; c < 4; c++) {
      int xx = ix - 1 + c;
      xx = xx < 0 ? 0 : (xx > W - 1 ? W - 1 : xx);
      row += wx[c] * img[(size_t)yy * W + xx];
    }
    v += wy[r] * row;
  }
  return v;
}

int run_event(const char* inp, const char* outp) {
  Reader rd(inp);
  if (!rd.f) return 1;
  int P = rd.i32(), H = rd.i32(), W = rd.i32(), norm_event = rd.i32();
  double fx = rd.f64(), fy = rd.f64(), cx = rd.f64(), cy = rd.f64();
  double px[3]; rd.arr(px, 3);
  double q[4]; rd.arr(q, 4);     // [w, x, y, z]
  double vx[6]; rd.arr(vx, 6);
  vector<double> ncx(P), ncy(P), gx(P), gy(P), idp(P), wts(P);
  rd.arr(ncx.data(), P); rd.arr(ncy.data(), P);
  rd.arr(gx.data(), P); rd.arr(gy.data(), P);
  rd.arr(idp.data(), P); rd.arr(wts.data(), P);
  vector<double> ef((size_t)H * W);
  rd.arr(ef.data(), ef.size());
  fclose(rd.f);

  // quaternion to R
  double w = q[0], xq = q[1], yq = q[2], zq = q[3];
  double R[3][3] = {
      {1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w * zq), 2 * (xq * zq + w * yq)},
      {2 * (xq * yq + w * zq), 1 - 2 * (xq * xq + zq * zq), 2 * (yq * zq - w * xq)},
      {2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq), 1 - 2 * (xq * xq + yq * yq)}};

  vector<double> model(P), res(P);
  double norm_sq = 1e-03;                    // :136 model_norm_sq(1e-03)
  for (int i = 0; i < P; i++) {
    double flow0 = (-idp[i] * vx[0]) + (ncx[i] * idp[i] * vx[2])
                   + (ncx[i] * ncy[i] * vx[3]) - (1.0 + ncx[i] * ncx[i]) * vx[4]
                   + (ncy[i] * vx[5]);
    double flow1 = (-idp[i] * vx[1]) + (ncy[i] * idp[i] * vx[2])
                   + (1.0 + ncy[i] * ncy[i]) * vx[3] - (ncx[i] * ncy[i]) * vx[4]
                   - (ncx[i] * vx[5]);
    model[i] = -(gx[i] * flow0 + gy[i] * flow1);
    norm_sq += model[i] * model[i];
  }
  double norm = std::sqrt(norm_sq);
  // NC variant: sampled event values normalized by their own l2 norm
  vector<double> evs(P);
  double ev_sq = 1e-03;
  for (int i = 0; i < P; i++) {
    double z = 1.0 / (idp[i] + 1e-05);
    double X[3] = {ncx[i] * z, ncy[i] * z, z};
    double p[3];
    for (int r = 0; r < 3; r++) {
      p[r] = px[r];
      for (int c = 0; c < 3; c++) p[r] += R[r][c] * X[c];
    }
    double xp = fx * (p[0] / p[2]) + cx;
    double yp = fy * (p[1] / p[2]) + cy;
    evs[i] = bicubic(ef, H, W, xp, yp);
    ev_sq += evs[i] * evs[i];
  }
  double evn = std::sqrt(ev_sq);
  for (int i = 0; i < P; i++) {
    double e = norm_event ? evs[i] / evn : evs[i];
    res[i] = wts[i] * (model[i] / norm - e);
  }

  Writer wr(outp);
  if (!wr.f) return 4;
  wr.i32(P);
  wr.arr(res.data(), P);
  wr.arr(model.data(), P);
  wr.f64(norm);
  fclose(wr.f);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) { fprintf(stderr, "usage: dso_golden ba|event in out\n"); return 64; }
  if (!strcmp(argv[1], "ba")) return run_ba(argv[2], argv[3]);
  if (!strcmp(argv[1], "event")) return run_event(argv[2], argv[3]);
  return 64;
}
