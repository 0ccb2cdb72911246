"""The plain reference: each model family's model and loss
(``<reference>.py``), the optimizers (``optimizers/<name>.py``) and the
float8 control, in plain PyTorch float32 with TF32 off. It imports
nothing of the program and takes from the benchmark only the weights and
batches the benchmark made (the model module's ``param_specs`` says
which leaves those are)."""
