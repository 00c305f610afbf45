"""Runtime layer of the port: deterministic fault injection
(``faultinject``), the registry the SpGEMM dispatch layer threads its
fault sites through; the worker-process coordinator (``coordinator``)
and the lane partition it re-meshes with (``elastic.remesh_lanes``).
The failure policies (retry, degradation ladder, quarantine) live in
``core/dispatch.py``."""
