"""The dry run's analysis: its cost model (``cost``), roofline terms
(``roofline``) and report tables (``report``)."""
