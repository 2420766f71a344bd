"""Launch layer of the port: meshes (``mesh.py``), the logical-axis
sharding resolver and placement on a ``DeviceMesh`` (``sharding.py``), the
train, prefill and decode step plans (``steps.py``), the training entry
point (``train.py``), and the dry run over a faked production job
(``dryrun.py``) with its cost model (``trace_cost.py``) and three-term
roofline and analytic useful FLOPs (``roofline.py``)."""
