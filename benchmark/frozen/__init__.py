"""A frozen copy of ``eqvio_tpu_torch``'s scene generator and frame-step
math, the benchmark's yardstick.

The program under test may change; this copy does not.  The benchmark
builds its scenes, IMU and simulated measurements from it, and the
reference that decides ``correct`` runs its filter, tracker and
simulation step eagerly, in float64 where the program runs float32, with
the plain KLT.  It imports nothing of the program and takes nothing the
program has made.
"""
