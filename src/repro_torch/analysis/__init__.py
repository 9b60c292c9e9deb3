"""Runtime analysis of the port: the determinism sanitizer
(``repro_torch.analysis.sanitize``)."""
