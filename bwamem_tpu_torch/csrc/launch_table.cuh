// The launch table of the extension kernels (band_pass.cuh's
// dispatch_shape): one ROW(largest query window, G, C) per shape, windows
// rising, G * C >= the window.  A window of up to that many columns runs
// with a group of G threads per alignment and a strip of C columns per
// thread in registers; above the last row (up to 1024 columns) a whole
// warp runs it with the H/E row in shared memory.  chip_tune.py times
// other tables by building a copy of the sources with this file replaced.

#pragma once

#define BWT_LAUNCH_TABLE(ROW)                                      \
  ROW(32, 8, 4) ROW(64, 16, 4) ROW(128, 32, 4) ROW(160, 32, 5)     \
  ROW(192, 32, 6) ROW(256, 32, 8)
