"""The benchmark's plain reference of the reactive planner's cycle.

Plain NumPy (host preparation) and plain PyTorch (the candidate
evaluation, in any dtype on any device).  It imports nothing of the
program: it derives the reference-path tables, the road corridor, the
obstacle tables and the candidate grids itself from the benchmark's inputs
(the loaded scenario, the route's polyline, the configuration's vehicle
parameters) and judges the program's answers against its own.

The semantics follow the upstream CommonRoad reactive planner
(``reactive_planner.py``, ``sampling.py``, ``cost_function.py``) as the
program documents them; this copy is frozen here so that a later change
of the program is held to today's semantics.
"""
