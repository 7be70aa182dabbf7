"""One module a model family, named by a configuration's ``family`` key."""
