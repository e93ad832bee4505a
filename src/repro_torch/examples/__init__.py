"""The port's counterparts of the reference's ``examples/``: each runs as
``python -m repro_torch.examples.<name>`` (``launch/train_lm.py`` stands in
for ``examples/train_lm.py``).

- ``synthesize_pod``: joint synthesis of several process groups' different
  collectives over one fabric (paper Fig. 15), on the planner copy.
- ``quickstart``: a process-group All-Gather and a whole-mesh All-to-All
  through ``CollectiveRequest``, the Direct baseline, the ppermute program,
  the MSCCL-IR export, the All-Gather executed on 16 ranks stacked in one
  tensor on the card (or the CPU with ``--device cpu``), and a plan repair.
- ``serve_batch``: a reduced LM in f32 prefilled by stepping
  ``decode_step`` over a batch of prompts, then decoded greedily.
"""
