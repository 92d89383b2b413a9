"""The benchmark harness of ``commonroad_rp_tpu_torch``: the run, its
window and trace, the inputs drawn from the seed, and the comparison with
the plain reference."""
