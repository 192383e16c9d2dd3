"""Multi-device proving: a mesh of shards over devices and
``torch.distributed`` (``mesh.py``), the distributed hypercube FFT
(``fft_dist.py``) and the sharded MSMs and prover cores (``sharded.py``).
Ports ``zecale_tpu/parallel/``."""
