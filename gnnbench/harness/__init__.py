"""The yardstick: the benchmark's definition, traffic, weights, the
comparison that decides ``correct``, the traced run and the table of peaks."""
