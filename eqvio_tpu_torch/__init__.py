"""PyTorch / CUDA port of ``eqvio_tpu``: equivariant visual-inertial odometry.

The package mirrors ``eqvio_tpu``'s module names (``lie``, ``states``,
``group``, ``charts``, ``matrices``, ``filter``, ``frontend``, ``io``,
``data``, ``app``) so every counterpart is easy to find.  It imports
``torch`` and never ``jax``; plain tensor code is PyTorch, and the one kernel
of the main path (pyramidal Lucas-Kanade) is a hand-written CUDA C++ kernel
for Hopper (``csrc/klt_cuda.cu``, bound in ``kernels/klt.py``).
"""
