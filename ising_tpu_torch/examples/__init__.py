"""The port's example studies, each the counterpart of the JAX package's
``examples/<name>.py`` with its flags, defaults and printed lines, plus
--device (default cuda):

    python3 -m ising_tpu_torch.examples.tc_sweep [--device cpu] ...

tc_sweep (Binder-cumulant Tc sweep over sub-lattice replicas),
reweight_peak (WHAM), xi_scan (xi_L/L crossing with Swendsen-Wang),
cluster_vs_metropolis (autocorrelation times), spin_glass_pt (parallel
tempering on a +-J glass), hysteresis (a cycled field) and giant_lattice
(the reference's 524288 x 65536 flagship on bit1).
"""
