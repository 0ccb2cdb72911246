"""The programs under test, one module a model family, named by a
configuration's ``program`` key. Each module's ``build(spec, optimizer,
device)`` returns the port's Trainer for the cell ``spec``, with
``optimizer`` the port's optimizer factory from ``optimizers/<name>.py``.
"""
