"""Share of its roofline of the deformable attention's backward: the least
time of the backward of every call of ``salience_detr::ms_deform_attn``
(``roofline/msda.py``, from the forward call's recorded shapes) over the
device time of the kernels its autograd node launched - found through the
forward operator's sequence number, not by kernel name - in percent."""

from portbench.roofline.msda import backward_work, share


def read(run):
    return share(run.trace.msda("bwd"), backward_work)
