"""The plain optimizers, one module a name, named by a configuration's
``optimizer.name``. Each module's ``Plain(o)`` has ``step(params,
grads)``, which updates ``params`` ({path: tensor}) in place."""
