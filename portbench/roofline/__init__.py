"""The yardstick of the kernels: published peaks of the card and the bytes and
operations each kernel call needs, computed from the call's shapes."""
