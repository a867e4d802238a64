"""The benchmark's harness: the cell's files found by name, the closed-loop
window, the trace and its reduction, and the result line."""
