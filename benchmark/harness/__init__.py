"""The benchmark's harness: the cells as data, the traffic drivers, the
traced slice, the work from shapes and the check of `correct`."""
