"""The cvxbook problems of the JAX package's tests/test_book_examples*.py
on the port: book.examplesK holds the problems of
test_book_examplesK.py (examples1: test_book_examples.py), each a pair
<name>_data(seed) -> numpy data and <name>(data) -> the port's
solution."""

#: module -> its problems, in the order of the JAX test files
PROBLEMS = {
    "examples1": ("huber", "tv", "basispursuit", "regsel", "maxent",
                  "expdesign", "covsel"),
    "examples2": ("linsep", "chernoff", "placement", "centers"),
    "examples3": ("l2ac", "logreg", "penalties", "cvxfit", "smoothrec"),
    "examples4": ("robls", "ellipsoids", "polapprox"),
    "examples5": ("consumerpref", "inputdesign", "probbounds",
                  "filterdemo", "rls"),
}
