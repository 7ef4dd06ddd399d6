// The launch tables of the extension kernels.  A window of up to QMAX
// query columns runs with a group of G threads per alignment and a strip
// of C columns per thread in registers (G * C >= QMAX); above the last
// window (up to 1024 columns) a whole warp runs it with the H/E row in
// shared memory.
// - BWT_LAUNCH_TABLE, the 32-bit cells' (band_pass.cuh's dispatch_shape):
//   ROW(QMAX, G, C), windows rising.
// - BWT_LAUNCH_TABLE16, the packed 16-bit cells' (band_pass16.cuh's
//   dispatch_shape16): ROW(QMAX, G, C), C even (a register holds two
//   columns).  Narrower groups with longer strips (8 threads of 14-20
//   columns) pay a row's bookkeeping over more cells, and won on batches
//   whose lanes run alike, but lost on the lanes that `mem` makes, whose
//   lengths spread (its fused batches joined to 16,384 lanes took 44%
//   longer; chip_tune.py, PERF.md).  So a lane keeps a whole warp from
//   65 columns up, as with 32-bit cells.
// chip_tune.py times other tables by building a copy of the sources with
// this file's macros replaced.

#pragma once

#define BWT_LAUNCH_TABLE(ROW)                                      \
  ROW(32, 8, 4) ROW(64, 16, 4) ROW(128, 32, 4) ROW(160, 32, 5)     \
  ROW(192, 32, 6) ROW(256, 32, 8)

#define BWT_LAUNCH_TABLE16(ROW)                                    \
  ROW(32, 8, 4) ROW(64, 16, 4) ROW(128, 32, 4) ROW(192, 32, 6)     \
  ROW(256, 32, 8)
