"""Host utilities: the native host runtime (`native`) and the stage
profiler (`profiler`)."""
