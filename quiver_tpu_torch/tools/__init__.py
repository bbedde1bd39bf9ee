"""Developer tooling shipped with the port.

``tools.lint`` is graftlint — the capture-safety / consistency static
analyzer (``python -m quiver_tpu_torch.tools.lint``). Tools here are
stdlib-only at analysis time: they parse source with ``ast`` and never
execute or import the code under analysis.
"""
