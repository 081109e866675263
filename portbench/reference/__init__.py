"""The benchmark's plain reference of Salience-DETR: float32 PyTorch, no
kernel of the program, TF32 off (``model.exact_float32``).

A frozen copy of the program's plain code at the time the benchmark was
written, with these departures: deformable attention is one ``grid_sample``
a level (``attention.py``), dense attention two matmuls around a softmax,
the Hungarian assignment is ``scipy.optimize.linear_sum_assignment`` and
every discrete choice goes through ``choices.py``, which can follow another
run's choices and judge them.  Nothing here imports the program; the
benchmark hands both sides the same state dict, images, targets and
contrastive-denoising draws."""
