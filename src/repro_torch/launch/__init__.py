"""Launch layer of the port: step plans (``steps.py``), the analytic
useful-FLOPs model (``roofline.py``) and the training entry point
(``train.py``).  Meshes, sharding rules, the prefill and decode plans and
the compiled-artifact cost model are ROADMAP A12."""
