// Gaussian-process regression + expected-improvement acquisition for the
// autotuner. Capability parity with /root/reference
// horovod/common/optim/{bayesian_optimization,gaussian_process}.{h,cc};
// fresh implementation: hand-rolled Cholesky on the (tiny) sample matrix and
// random-search EI maximization instead of Eigen + L-BFGS — the search space
// is 2-dimensional, where random search is entirely adequate.
#ifndef HVD_TPU_BAYESIAN_OPTIMIZATION_H
#define HVD_TPU_BAYESIAN_OPTIMIZATION_H

#include <cstdint>
#include <utility>
#include <vector>

namespace hvdtpu {

class GaussianProcess {
 public:
  // RBF kernel with fixed hyperparameters on [0,1]-normalized inputs.
  GaussianProcess(double length_scale = 0.2, double signal_var = 1.0,
                  double noise_var = 1e-4)
      : length_scale_(length_scale),
        signal_var_(signal_var),
        noise_var_(noise_var) {}

  void Fit(const std::vector<std::vector<double>>& x,
           const std::vector<double>& y);
  void Predict(const std::vector<double>& x, double* mu, double* sigma) const;

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;

  double length_scale_, signal_var_, noise_var_;
  std::vector<std::vector<double>> x_;
  std::vector<std::vector<double>> chol_;  // lower-triangular L of K+noise I
  std::vector<double> alpha_;              // (K+noise I)^-1 (y - mean)
  double y_mean_ = 0.0;
  double y_scale_ = 1.0;
};

class BayesianOptimizer {
 public:
  explicit BayesianOptimizer(
      std::vector<std::pair<double, double>> bounds, uint64_t seed = 42);

  // Next point to evaluate: random for the first few samples, then argmax of
  // expected improvement over a random candidate sweep.
  std::vector<double> NextSample();
  void AddSample(const std::vector<double>& x, double y);
  std::vector<double> BestSample() const;
  double BestValue() const { return best_y_; }
  std::size_t NumSamples() const { return x_.size(); }

 private:
  std::vector<double> Normalize(const std::vector<double>& x) const;
  std::vector<double> Denormalize(const std::vector<double>& z) const;
  double NextRand();  // xorshift in [0,1)

  std::vector<std::pair<double, double>> bounds_;
  GaussianProcess gp_;
  std::vector<std::vector<double>> x_;  // normalized
  std::vector<double> y_;
  std::vector<double> best_x_;  // denormalized
  double best_y_;
  uint64_t rng_state_;
};

}  // namespace hvdtpu

#endif  // HVD_TPU_BAYESIAN_OPTIMIZATION_H
