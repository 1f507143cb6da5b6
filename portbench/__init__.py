"""The benchmark of walk_these_ways_tpu_torch: one PPO training job of the
Go1 MoB task per cell, timed over a window of whole iterations, with the
outputs of its first iterations held against a plain reference.  See
README.md."""
