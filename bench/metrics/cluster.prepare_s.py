"""The intent's PREPARE: `DowntimeReport.prepare_s` of its swap (seconds
on the PREPARE worker, serving beside it)."""


def read(run):
    return None if run.report is None else float(run.report.prepare_s)
