"""The JAX package's examples on the port, each at its own settings on the
fixtures: the trench of disks in 2D and 3D (``disk2D``, ``disk3D``), the 2D
trench as native line segments (``line2D``) and as extruded triangles
(``triangle2D``), the 3D triangle trench (``triangle3D``), each of which
takes the reference's ``.dat`` file where one is named; a two-channel
particle (``multi_channel``), two species through ``apply_particles``
(``multi_species``), an energy-carrying ion (``stateful_ion``) and the
sharded trace (``sharded_trace``). Each runs on the CUDA device unless
``--device cpu`` is given: ``python3 -m
viennaray_tpu_torch.examples.disk3D [--device cpu]``."""
