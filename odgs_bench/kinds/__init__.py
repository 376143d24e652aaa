"""The kinds of cell.  A traffic file's `kind` names a module here, found
by that name, which provides:

  run(cell, seed, seconds, traced, t_start, device) -> dict
      one run: setup_s, window (with `trace` when traced), gaps,
      memory_peak_bytes, attempted;
  e2e(res) -> {quantity: value}   the end-to-end quantities of a run
      (setup_s and memory_peak_gb are the harness's own);
  window_line(res) -> str         what the window did, for standard error;
  readings(cell, seed, count, device, **opts) -> rows
      the check's numbers of `count` seeds, for setting its limits
      (python3 -m odgs_bench.readings).
"""
