"""One driver per kind of entry point; a configuration names its own
(``"driver"`` in ``configs/<config>.json``)."""
