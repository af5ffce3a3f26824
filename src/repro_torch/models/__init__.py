"""Target models (dense family) and the ``Model`` facade
(``models.registry``)."""
