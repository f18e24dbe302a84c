"""The TPU-compiler probes of the JAX package's ``tools/``, on the card.

    python -m sesr_tpu_torch.probes {conv,gemm,bitcast} [--device cpu]

``conv.py``       tools/bench_probe_pallas_conv.py (P1)
``int8_gemm.py``  tools/bench_probe_pallas_int8.py (P2)
``bitcast.py``    tools/bench_probe_r3a.py:323 and tools/bench_probe_r3b.py:63/107
                  (P3-P6)

Each probe runs the hand-written kernels of ``csrc/probes.cu`` (wrappers in
``kernels.py``) on CUDA tensors and their plain versions (``plain.py``) on
CPU tensors. Importing this package builds and loads nothing.
"""
