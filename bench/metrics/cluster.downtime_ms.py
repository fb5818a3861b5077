"""The intent's swap window: `DowntimeReport.downtime_s`, in ms."""


def read(run):
    return None if run.report is None else 1e3 * float(run.report.downtime_s)
