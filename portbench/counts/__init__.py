"""The yardstick's arithmetic, frozen in the benchmark so that a change to
the program cannot move it: the attention bound, the model's operation
count and the grouping of device operations."""
