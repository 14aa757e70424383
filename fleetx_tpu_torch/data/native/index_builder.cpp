// Native dataset-index builder (C ABI, consumed via ctypes): the port's
// copy of `fleetx_tpu/data/native/index_builder.cpp`.
//
// Counterpart of the reference's pybind11 helper
// `ppfleetx/data/data_tools/cpp/fast_index_map_helpers.cpp`
// (build_sample_idx l.92-190, build_blending_indices l.32-89). The Python
// side (`fleetx_tpu_torch/data/dataset/gpt_dataset.py`) keeps the numpy
// builders; this one gives byte-identical outputs (held by
// tests/test_torch_native_index.py) in O(1) memory per step instead of a
// cumulative-length array.
//
// Built on first use by `fleetx_tpu_torch/data/native/__init__.py` with
// `g++ -O3 -std=c++17 -fPIC -shared` into `fleetx_tpu_torch/_build/`.

#include <cstdint>

extern "C" {

// Sample index for GPT pretraining: sample i starts at stream position
// i*seq_length of the doc_idx-ordered token stream. Writes
// (doc_idx position, token offset) rows into out[(num_samples+1) x 2].
// num_samples must already be clamped to (total_tokens-1)/seq_length.
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int64_t n_docs, int64_t seq_length, int64_t num_samples,
                      int64_t* out) {
  int64_t pos = 0;          // index into doc_idx
  int64_t cum_before = 0;   // tokens in docs [0, pos)
  for (int64_t i = 0; i <= num_samples; ++i) {
    const int64_t start = i * seq_length;
    while (pos < n_docs &&
           cum_before + static_cast<int64_t>(sizes[doc_idx[pos]]) <= start) {
      cum_before += static_cast<int64_t>(sizes[doc_idx[pos]]);
      ++pos;
    }
    out[2 * i] = pos;
    out[2 * i + 1] = start - cum_before;
  }
}

// Error-minimising greedy assignment of samples to weighted datasets
// (multi-corpus blending, reference build_blending_indices l.32-89):
// at every step pick the dataset whose achieved fraction lags its weight
// the most.
void build_blending_indices(const double* weights, int64_t n_datasets,
                            int64_t num_samples, int32_t* dataset_index,
                            int64_t* dataset_sample_index) {
  int64_t counts[256];
  for (int64_t d = 0; d < n_datasets && d < 256; ++d) counts[d] = 0;
  for (int64_t i = 0; i < num_samples; ++i) {
    const double target = static_cast<double>(i + 1);
    int64_t best = 0;
    double best_err = weights[0] * target - static_cast<double>(counts[0]);
    for (int64_t d = 1; d < n_datasets; ++d) {
      const double err = weights[d] * target - static_cast<double>(counts[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    dataset_index[i] = static_cast<int32_t>(best);
    dataset_sample_index[i] = counts[best];
    ++counts[best];
  }
}

}  // extern "C"
