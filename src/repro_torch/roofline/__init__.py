"""Roofline: the analytic ledger and the H100's terms (``analysis``), the
dry run's collective census (``census``) and the report (``report``)."""
