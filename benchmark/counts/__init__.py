"""Counting functions: the operations, exps and bytes that a kernel call
or a request needs, from its shapes alone (each input byte read once,
each output byte written once, masked-off work not counted)."""
