"""setup_s: seconds from the process's start to the first timed step
(host clock): loading, building, warming and the check's first steps."""


def read(rec):
    return rec["setup_s"]
