"""The float network of the port: the analytic collapse (``blocks.py``)
and the collapsed SESR net (``sesr.py``)."""
