// The row-group rule of the normalize kernel (normalize.cu).
//
// Its grid is (column blocks) x (row groups): a block walks `rows`
// consecutive rows of its columns.  A short batch takes a row a block, so
// enough blocks are in flight; a long one up to MAX_ROWS a block, so a
// block reuses what it holds in registers across its rows.  `rows` is the
// fewest that keep ~BLOCKS_PER_SM blocks on each of the card's SMs, which
// is read from the device.

#pragma once

#include <algorithm>
#include <cuda_runtime.h>

namespace {

// rows a block walks per pass, all their loads in flight at once (8 held
// more registers than the loads gained)
constexpr int MAX_ROWS = 4;
constexpr long long BLOCKS_PER_SM = 4;
constexpr long long MAX_GRID_Y = 65535;

struct RowGroups {
  int rows;         // rows a block walks per pass
  unsigned groups;  // grid.y; a block strides by groups * rows
};

// `blocks_per_group`: the blocks that cover one row group (column blocks
// times inputs).
inline cudaError_t row_groups(long long batch, long long blocks_per_group,
                              int device, RowGroups* out) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long target = BLOCKS_PER_SM * std::max(sms, 1);
  out->rows = static_cast<int>(std::min<long long>(
      MAX_ROWS, std::max<long long>(1, batch * blocks_per_group / target)));
  out->groups = static_cast<unsigned>(
      std::min<long long>((batch + out->rows - 1) / out->rows, MAX_GRID_Y));
  return cudaSuccess;
}

}  // namespace
