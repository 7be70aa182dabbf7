"""One module a kind of traffic, named by a traffic mix's ``kind`` key."""
