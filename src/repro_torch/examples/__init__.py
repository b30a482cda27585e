"""The paper's example flows on the port, one module each, each a function
of its sizes with a ``main()`` at the examples' sizes:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.latency_tolerance
    python -m repro_torch.examples.sweep_study
    python -m repro_torch.examples.collective_study   # Fig 10, the service
    python -m repro_torch.examples.topology_study     # Fig 11, the service
    python -m repro_torch.examples.explore_study

(with ``PYTHONPATH=src``).  Each is the flow of its counterpart in the
repository's ``examples/`` on the port's entry points, on the CUDA card
unless ``--device cpu`` is given.
"""
