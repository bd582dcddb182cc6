"""The benchmark's harness: the run (`harness`), the scene generator
(`scenes`), seeded weights (`weights`), the peaks and the bound
arithmetic (`arith`), the profiler window (`trace`) and the comparisons
that decide `correct` (`compare`). It imports the port only where a
driver drives it; `rfdref` is the plain reference."""
