"""Developer tooling shipped with the port.

``tools.lint`` is graftlint, the capture-safety / consistency static
analyzer (``python -m quiver_tpu_torch.tools.lint``): stdlib-only, it
parses source with ``ast`` and never executes or imports the code under
analysis. ``tools.audit`` is graftaudit, the program auditor (``python -m
quiver_tpu_torch.tools.audit``): it runs each registered program once on
small inputs under a recorder and checks what it ran and held (the
collective schedule, writes in place, dtypes, memory, kernel resources).
Both report through ``tools.sarif``.
"""
