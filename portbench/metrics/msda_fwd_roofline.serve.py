"""Share of its roofline of the deformable attention's forward: the least
time of every call of the operator ``salience_detr::ms_deform_attn`` in the
traced window (``roofline/msda.py``, from the call's recorded shapes) over
the device time of the kernels launched inside those calls, in percent."""

from portbench.roofline.msda import forward_work, share


def read(run):
    return share(run.trace.msda("fwd"), forward_work)
