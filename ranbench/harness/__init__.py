"""The benchmark's yardstick: the manifest and cell files, the result
line, the import guard, host spans, the profiler trace and its reduction
(busy and idle time, top device operations, idle gaps by host span),
percentiles, and the roofline of the LDPC kernels.  Nothing here imports
the program."""
