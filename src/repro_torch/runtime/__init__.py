"""Runtime layer of the port: deterministic fault injection
(``faultinject``), the registry the SpGEMM dispatch layer threads its
fault sites through; the worker-process coordinator (``coordinator``)
and the lane partition it re-meshes with (``elastic.remesh_lanes``);
elastic rescaling of the model paths (``elastic.remesh``,
``elastic.reshard_restore``);
training's supervised loop (``fault.run_resilient``).  The SpGEMM
failure policies (retry, degradation ladder, quarantine) live in
``core/dispatch.py``."""
