// Host-side index-map builders for Megatron-style token datasets: the
// PyTorch port's own copy of paddlefleetx_tpu/data/cpp/helpers.cpp (the
// same four extern "C" functions, the same walks), built by
// paddlefleetx_tpu_torch/data/_build.py with g++ into build/ and loaded
// with ctypes.  Host code, not a kernel: O(tokens) two-pointer walks that
// the numpy versions in paddlefleetx_tpu_torch/data/indexed.py mirror
// exactly.

#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Map each fixed-length training sample to (doc_idx position, in-doc offset).
// out: int32 [(num_samples+1) * 2].  A sample spans seq_length tokens plus a
// one-token overlap for the shifted language-modeling label.
void build_sample_idx(const int32_t* sizes, const int32_t* doc_idx,
                      int32_t seq_length, int64_t num_samples, int32_t* out) {
  int64_t di = 0;
  int32_t offset = 0;
  out[0] = 0;
  out[1] = 0;
  for (int64_t i = 1; i <= num_samples; ++i) {
    int32_t remaining = seq_length;
    while (remaining > 0) {
      int32_t doc_len = sizes[doc_idx[di]] - offset;
      if (doc_len > remaining) {
        offset += remaining;
        remaining = 0;
      } else {
        remaining -= doc_len;
        ++di;
        offset = 0;
      }
    }
    out[2 * i] = static_cast<int32_t>(di);
    out[2 * i + 1] = offset;
  }
}

// Greedy weighted interleaving of multiple datasets: at every step emit from
// the dataset whose emitted fraction lags its target weight the most.
void build_blending_indices(const double* weights, int32_t num_datasets,
                            int64_t num_samples, int8_t* ds_index,
                            int64_t* ds_sample) {
  std::vector<int64_t> counts(num_datasets, 0);
  for (int64_t i = 0; i < num_samples; ++i) {
    int32_t best = 0;
    double best_err = -1e300;
    for (int32_t d = 0; d < num_datasets; ++d) {
      double err = weights[d] * static_cast<double>(i + 1) -
                   static_cast<double>(counts[d]);
      if (err > best_err) {
        best_err = err;
        best = d;
      }
    }
    ds_index[i] = static_cast<int8_t>(best);
    ds_sample[i] = counts[best];
    ++counts[best];
  }
}

// BERT/ERNIE-style sentence-pair sample map (reference build_mapping):
// emits (start_doc_sentence_index, end_doc_sentence_index, target_seq_len)
// triples for masked-LM training over documents of sentences.
//
// docs:   int64 [num_docs+1] sentence-index boundaries per document
// sizes:  int32 [num_sentences] token length per sentence
// out:    int64 [max_out * 3]; returns number of triples written.
int64_t build_mapping(const int64_t* docs, int64_t num_docs,
                      const int32_t* sizes, int32_t max_seq_length,
                      double short_seq_prob, uint64_t seed, int64_t max_out,
                      int64_t* out, int32_t min_num_sent) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  int64_t written = 0;
  const int32_t max_tokens = max_seq_length - 3;  // [CLS] a [SEP] b [SEP]
  for (int64_t doc = 0; doc < num_docs; ++doc) {
    const int64_t sent_begin = docs[doc];
    const int64_t sent_end = docs[doc + 1];
    int32_t target = max_tokens;
    if (short_seq_prob > 0.0 && unif(rng) < short_seq_prob) {
      target = 2 + static_cast<int32_t>(unif(rng) * (max_tokens - 1));
    }
    int64_t start = sent_begin;
    int32_t tok_count = 0;
    int64_t num_sent = 0;
    for (int64_t s = sent_begin; s < sent_end; ++s) {
      tok_count += sizes[s];
      ++num_sent;
      const bool last = (s == sent_end - 1);
      if ((tok_count >= target && num_sent >= min_num_sent) || last) {
        if (num_sent >= min_num_sent && tok_count > 1) {
          if (written < max_out) {
            out[3 * written] = start;
            out[3 * written + 1] = s + 1;
            out[3 * written + 2] = target;
          }
          ++written;
        }
        start = s + 1;
        tok_count = 0;
        num_sent = 0;
        if (short_seq_prob > 0.0 && unif(rng) < short_seq_prob) {
          target = 2 + static_cast<int32_t>(unif(rng) * (max_tokens - 1));
        } else {
          target = max_tokens;
        }
      }
    }
  }
  return written;
}

// Block-based sample map (reference build_blocks_mapping): fixed token
// blocks for span-masking pretrain; emits (sentence_start, sentence_end,
// doc_index, block_len) quadruples.
int64_t build_blocks_mapping(const int64_t* docs, int64_t num_docs,
                             const int32_t* sizes, int32_t max_seq_length,
                             uint64_t seed, int64_t max_out, int64_t* out) {
  std::mt19937_64 rng(seed);
  int64_t written = 0;
  const int32_t max_tokens = max_seq_length - 2;  // [CLS] ... [SEP]
  for (int64_t doc = 0; doc < num_docs; ++doc) {
    const int64_t sent_begin = docs[doc];
    const int64_t sent_end = docs[doc + 1];
    int64_t start = sent_begin;
    int32_t tok_count = 0;
    for (int64_t s = sent_begin; s < sent_end; ++s) {
      tok_count += sizes[s];
      const bool last = (s == sent_end - 1);
      if (tok_count >= max_tokens || last) {
        if (tok_count > 1) {
          if (written < max_out) {
            out[4 * written] = start;
            out[4 * written + 1] = s + 1;
            out[4 * written + 2] = doc;
            out[4 * written + 3] = tok_count < max_tokens ? tok_count : max_tokens;
          }
          ++written;
        }
        start = s + 1;
        tok_count = 0;
      }
    }
  }
  return written;
}

}  // extern "C"
