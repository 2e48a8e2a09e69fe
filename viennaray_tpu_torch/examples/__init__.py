"""The JAX package's custom-particle examples on the port: a two-channel
particle (``multi_channel``), two species through ``apply_particles``
(``multi_species``) and an energy-carrying ion (``stateful_ion``), each at
its own settings on the fixtures. Each module's ``make_tracer`` builds the
configured tracer (the CUDA device unless ``device`` is given) and ``main``
runs it: ``python3 -m viennaray_tpu_torch.examples.multi_channel
[--device cpu]``."""
