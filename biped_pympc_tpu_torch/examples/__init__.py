"""Twins of the JAX package's `examples/`: the closed loop, the whole rollout
and the RL-MPC environments and trainers, on the port's controller."""
