"""The port's optimizers, one module a name, named by a configuration's
``optimizer.name``. Each module's ``build(o)`` returns the port's
optimizer factory for the hyperparameters ``o``, and
``first_gradient(slot, o)`` the first step's gradient of one leaf as the
optimizer got it, worked out from that leaf's state after one step.
"""
