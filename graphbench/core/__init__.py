"""The benchmark's fixed parts: finding a cell's files, building its graph, the
closed loop, the trace's arithmetic and the table of peaks."""
