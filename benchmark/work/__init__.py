"""The least work of each kernel family, counted from the algorithm and
the cell's shapes: what any implementation has to compute and move, with
no recompute and each input byte read once and each output byte written
once. The counts are frozen in each workload's file (`work`), so a
roofline share means the same whatever implements the kernel."""
