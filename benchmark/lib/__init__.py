"""The harness: cells by name (spec), the card (card), the import guard
(guard), the traffic drivers and the program they drive (drivers), the
profiler's reduction (trace), the roofline's least time (roofline), the
output comparison (check) and one run of one cell (harness)."""
