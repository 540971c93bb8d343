"""The plain reference of the benchmark: adaptive tube MPC written again in batched
PyTorch matrices, from the configuration's values alone.

It imports nothing of the program under test (``tube_mpc_tpu_torch``) and nothing of
JAX, and takes nothing the program made: it builds its own dynamics, barrier, costs and
solvers from the configuration file. ``plant`` holds the dynamics and the barrier state,
``tube`` the iLQR solve, the δz sensitivity and the paper step of Algorithm 2."""
