"""The port's counterparts of the JAX package's ``examples/``, run as
modules; each takes ``--device`` (the card unless named, and raises without
one)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu] [--steps 300]

``cnn_inference_speed.py``'s counterpart is ``repro_torch.launch.cnn``.
Each module's ``main(argv)`` prints what the JAX example prints, keeps its
assertions, and returns its numbers.
"""
