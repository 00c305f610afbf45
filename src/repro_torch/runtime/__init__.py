"""Runtime layer of the port: deterministic fault injection
(``faultinject``), the registry the SpGEMM dispatch layer threads its
fault sites through.  The failure policies (retry, degradation ladder,
quarantine) live in ``core/dispatch.py``."""
