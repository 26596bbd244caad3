"""The dry run's analysis: its cost model (``cost``), roofline terms
(``roofline``) and report tables (``report``); and ``pav_precision``,
which measures how far the f32 PAV solves drift from f64 on the CPU."""
