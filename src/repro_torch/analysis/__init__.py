"""The port's analytic cost model: the H100's figures (``hw``) and the
parameter and FLOP counts of a configuration (``roofline``)."""
