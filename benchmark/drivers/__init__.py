"""The drivers: one module a kind of traffic, named by a traffic file's
"driver".  Each has a class `Run(cell, seed, device, trace)` whose
construction is the set-up, and the methods
  window(seconds) -> {"attempted", "failed", "values", "units", "seconds"}
      the measured closed loop; `values` by the names the traffic file
      maps to end-to-end metrics;
  unit()          one unit of the same work, for the profiled window;
  counts()        {"flops_per_unit", "bound_s_per_unit"} from the shapes;
  spans()         {name: [ms]} of the benchmark's spans (traced runs);
  release()       drop the program's state (the model, its caches);
  check()         [(name, value, limit)], the comparison with the plain
                  reference, run after release().
"""
