"""Native serving of the exported model: the C++ runner of an AOTInductor
package (``aoti_runner.{h,cc}``, ``stereo_infer_main.cc``) and its build
(``build.py``)."""
