"""The probes of ``scripts/`` on the card: small kernels that measure the card
rather than compute a model (``csrc/probes.cu``).

- `entry_overhead` (P1): the cost of one kernel entry, eagerly and inside a
  CUDA graph; each fused decode stage alone; the whole decode step as graph
  replays and as the eager loop.
- `dma` (P2): the streaming rate of the packed words, summed as they are and
  unpacked into their nibble planes.
- `dma2` (P3): the rate when every byte of a tile passes through shared
  memory, at three tile widths, on a ring of bulk asynchronous copies that
  `dma`'s `unpack_only` shares (`common.stream_plan`); `ring_sweep` sweeps
  the ring's plans, `sass` counts the instructions a word of `unpack_only`'s
  hot loop in the built library.
- `gemv_ablation` (P4): the decode matvec with parts of its dequantization
  cut, against the port's own matvec (K6) at the same shapes.

Each runs as ``python -m qeft_tpu_torch.probes.<name>``, on the GPU unless
``--device cpu`` is passed (the plain versions only; no times).
"""
