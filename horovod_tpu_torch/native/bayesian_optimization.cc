#include "bayesian_optimization.h"

#include <cmath>
#include <limits>

namespace hvdtpu {

double GaussianProcess::Kernel(const std::vector<double>& a,
                               const std::vector<double>& b) const {
  double d2 = 0.0;
  for (std::size_t i = 0; i < a.size(); ++i) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return signal_var_ * std::exp(-d2 / (2.0 * length_scale_ * length_scale_));
}

void GaussianProcess::Fit(const std::vector<std::vector<double>>& x,
                          const std::vector<double>& y) {
  x_ = x;
  std::size_t n = x.size();
  // Center and scale targets for numerical stability.
  y_mean_ = 0.0;
  for (double v : y) y_mean_ += v;
  y_mean_ /= static_cast<double>(n);
  y_scale_ = 1e-12;
  for (double v : y) y_scale_ = std::max(y_scale_, std::fabs(v - y_mean_));
  std::vector<double> yc(n);
  for (std::size_t i = 0; i < n; ++i) yc[i] = (y[i] - y_mean_) / y_scale_;

  // K + noise I, then Cholesky L L^T.
  std::vector<std::vector<double>> k(n, std::vector<double>(n));
  for (std::size_t i = 0; i < n; ++i) {
    for (std::size_t j = 0; j <= i; ++j) {
      k[i][j] = k[j][i] = Kernel(x[i], x[j]);
    }
    k[i][i] += noise_var_;
  }
  chol_.assign(n, std::vector<double>(n, 0.0));
  for (std::size_t i = 0; i < n; ++i) {
    for (std::size_t j = 0; j <= i; ++j) {
      double sum = k[i][j];
      for (std::size_t m = 0; m < j; ++m) sum -= chol_[i][m] * chol_[j][m];
      if (i == j) {
        chol_[i][i] = std::sqrt(std::max(sum, 1e-12));
      } else {
        chol_[i][j] = sum / chol_[j][j];
      }
    }
  }
  // alpha = (K + nI)^-1 yc via two triangular solves.
  std::vector<double> z(n);
  for (std::size_t i = 0; i < n; ++i) {
    double sum = yc[i];
    for (std::size_t m = 0; m < i; ++m) sum -= chol_[i][m] * z[m];
    z[i] = sum / chol_[i][i];
  }
  alpha_.assign(n, 0.0);
  for (std::size_t ii = n; ii-- > 0;) {
    double sum = z[ii];
    for (std::size_t m = ii + 1; m < n; ++m) sum -= chol_[m][ii] * alpha_[m];
    alpha_[ii] = sum / chol_[ii][ii];
  }
}

void GaussianProcess::Predict(const std::vector<double>& x, double* mu,
                              double* sigma) const {
  std::size_t n = x_.size();
  if (n == 0) {
    *mu = 0.0;
    *sigma = std::sqrt(signal_var_);
    return;
  }
  std::vector<double> ks(n);
  for (std::size_t i = 0; i < n; ++i) ks[i] = Kernel(x, x_[i]);
  double m = 0.0;
  for (std::size_t i = 0; i < n; ++i) m += ks[i] * alpha_[i];
  *mu = m * y_scale_ + y_mean_;
  // v = L^-1 ks; var = k(x,x) - v.v
  std::vector<double> v(n);
  for (std::size_t i = 0; i < n; ++i) {
    double sum = ks[i];
    for (std::size_t mi = 0; mi < i; ++mi) sum -= chol_[i][mi] * v[mi];
    v[i] = sum / chol_[i][i];
  }
  double var = Kernel(x, x);
  for (std::size_t i = 0; i < n; ++i) var -= v[i] * v[i];
  *sigma = std::sqrt(std::max(var, 1e-12)) * y_scale_;
}

BayesianOptimizer::BayesianOptimizer(
    std::vector<std::pair<double, double>> bounds, uint64_t seed)
    : bounds_(std::move(bounds)),
      best_y_(-std::numeric_limits<double>::infinity()),
      rng_state_(seed ? seed : 1) {}

double BayesianOptimizer::NextRand() {
  // xorshift64* — deterministic, dependency-free.
  rng_state_ ^= rng_state_ >> 12;
  rng_state_ ^= rng_state_ << 25;
  rng_state_ ^= rng_state_ >> 27;
  uint64_t r = rng_state_ * 2685821657736338717ull;
  return static_cast<double>(r >> 11) / 9007199254740992.0;
}

std::vector<double> BayesianOptimizer::Normalize(
    const std::vector<double>& x) const {
  std::vector<double> z(x.size());
  for (std::size_t i = 0; i < x.size(); ++i) {
    double lo = bounds_[i].first, hi = bounds_[i].second;
    z[i] = (x[i] - lo) / (hi - lo);
  }
  return z;
}

std::vector<double> BayesianOptimizer::Denormalize(
    const std::vector<double>& z) const {
  std::vector<double> x(z.size());
  for (std::size_t i = 0; i < z.size(); ++i) {
    double lo = bounds_[i].first, hi = bounds_[i].second;
    x[i] = lo + z[i] * (hi - lo);
  }
  return x;
}

std::vector<double> BayesianOptimizer::NextSample() {
  std::size_t d = bounds_.size();
  if (x_.size() < 3) {
    // Bootstrap with quasi-random exploration.
    std::vector<double> z(d);
    for (std::size_t i = 0; i < d; ++i) z[i] = NextRand();
    return Denormalize(z);
  }
  gp_.Fit(x_, y_);
  // Expected improvement over random candidates.
  double best_ei = -1.0;
  std::vector<double> best_z(d, 0.5);
  const double xi = 0.01;
  for (int c = 0; c < 512; ++c) {
    std::vector<double> z(d);
    for (std::size_t i = 0; i < d; ++i) z[i] = NextRand();
    double mu, sigma;
    gp_.Predict(z, &mu, &sigma);
    double improve = mu - best_y_ - xi;
    double ei;
    if (sigma < 1e-12) {
      ei = improve > 0 ? improve : 0.0;
    } else {
      double u = improve / sigma;
      double cdf = 0.5 * std::erfc(-u / std::sqrt(2.0));
      double pdf = std::exp(-0.5 * u * u) / std::sqrt(2.0 * M_PI);
      ei = improve * cdf + sigma * pdf;
    }
    if (ei > best_ei) {
      best_ei = ei;
      best_z = z;
    }
  }
  return Denormalize(best_z);
}

void BayesianOptimizer::AddSample(const std::vector<double>& x, double y) {
  x_.push_back(Normalize(x));
  y_.push_back(y);
  if (y > best_y_) {
    best_y_ = y;
    best_x_ = x;
  }
}

std::vector<double> BayesianOptimizer::BestSample() const {
  if (!best_x_.empty()) return best_x_;
  std::vector<double> mid(bounds_.size());
  for (std::size_t i = 0; i < bounds_.size(); ++i) {
    mid[i] = 0.5 * (bounds_[i].first + bounds_[i].second);
  }
  return mid;
}

}  // namespace hvdtpu
