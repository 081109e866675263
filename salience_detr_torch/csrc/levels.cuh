// Shared by the kernels of this directory: the static multi-scale level table,
// passed to each C entry point (and on to its kernel) by value.  Mirrored by
// ``LevelTable`` in salience_detr_torch/native.py.
#pragma once

#include <cuda_runtime.h>

constexpr int kLevelsMax = 16;

struct LevelTable {
  int num_levels;
  int h[kLevelsMax];
  int w[kLevelsMax];
  int start[kLevelsMax];  // first flat token of each level
};

inline int level_table_tokens(const LevelTable& t) {
  int s = 0;
  for (int l = 0; l < t.num_levels; ++l) s += t.h[l] * t.w[l];
  return s;
}
