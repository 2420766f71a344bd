"""Launch layer of the port: meshes (``mesh.py``), the logical-axis
sharding resolver and placement on a ``DeviceMesh`` (``sharding.py``), the
train, prefill and decode step plans (``steps.py``), the analytic
useful-FLOPs model (``roofline.py``) and the training entry point
(``train.py``).  The dry run over a faked production mesh and the
compiled-artifact cost model are ROADMAP A12c."""
