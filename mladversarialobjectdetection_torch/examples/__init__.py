"""The example workflows of the JAX package's `examples/`, on the port.

Each module has the example's own name and runs as
`python -m mladversarialobjectdetection_torch.examples.<name>`, on the card
unless `--device cpu` is given:

- `production_soak`: train a lite4@640 victim on labelled scenes, gate it
  on its detections, attack it at the attack driver's operating point and
  train the defender against the learned patch (`soak.json`);
- `northstar_soak`: the reference-shaped epoch soak with a fixed
  validation pool, ReduceLROnPlateau and best-artifact naming
  (`northstar.json`), or the ASR-vs-scale frontier (`frontier.json`);
- `end_to_end_attack`: the same workflow at lite0@128 on rectangle scenes.

The victim and its scenes come from `train/victim.py` and
`data/pipeline.py`, so the scenes equal the JAX examples' for a seed. The
patch and U-Net states are drawn by the port's own `init_state(seed)` from
the seeds where JAX uses `PRNGKey(seed)`, so the patches are not JAX's.
"""
