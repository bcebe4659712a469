"""The port's analytic cost model: the H100's figures (``hw``), the
parameter and FLOP counts of a configuration and the roofline terms of a
traced step (``roofline``), and the collectives and FLOPs of that trace
(``collectives``, the counterpart of the reference's ``hlo``)."""
