// Minimal JSON value + parser + serializer for the ktpu native components.
// The device-plugin wire protocol (deviceplugin/api.py) is newline-delimited
// single-line JSON frames, so this only needs correct RFC 8259 parsing of
// objects/arrays/strings/numbers/bools/null — no streaming, no comments.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace ktpu {

class Json;
using JsonObject = std::map<std::string, Json>;
using JsonArray = std::vector<Json>;

class Json {
 public:
  enum class Type { Null, Bool, Number, String, Array, Object };

  Json() : type_(Type::Null) {}
  Json(bool b) : type_(Type::Bool), bool_(b) {}
  Json(double n) : type_(Type::Number), num_(n) {}
  Json(int n) : type_(Type::Number), num_(n) {}
  Json(int64_t n) : type_(Type::Number), num_(static_cast<double>(n)) {}
  Json(const char* s) : type_(Type::String), str_(s) {}
  Json(std::string s) : type_(Type::String), str_(std::move(s)) {}
  Json(JsonArray a) : type_(Type::Array), arr_(std::move(a)) {}
  Json(JsonObject o) : type_(Type::Object), obj_(std::move(o)) {}

  Type type() const { return type_; }
  bool is_null() const { return type_ == Type::Null; }
  bool is_object() const { return type_ == Type::Object; }
  bool is_array() const { return type_ == Type::Array; }
  bool is_string() const { return type_ == Type::String; }

  bool as_bool(bool dflt = false) const {
    return type_ == Type::Bool ? bool_ : dflt;
  }
  double as_number(double dflt = 0) const {
    return type_ == Type::Number ? num_ : dflt;
  }
  int64_t as_int(int64_t dflt = 0) const {
    return type_ == Type::Number ? static_cast<int64_t>(num_) : dflt;
  }
  const std::string& as_string() const { return str_; }
  const JsonArray& as_array() const { return arr_; }
  const JsonObject& as_object() const { return obj_; }
  JsonArray& arr() { return arr_; }
  JsonObject& obj() { return obj_; }

  // object field access; returns Null json for missing keys
  const Json& operator[](const std::string& key) const {
    static const Json null_json;
    auto it = obj_.find(key);
    return it == obj_.end() ? null_json : it->second;
  }

  std::string get(const std::string& key, const std::string& dflt = "") const {
    const Json& v = (*this)[key];
    return v.is_string() ? v.as_string() : dflt;
  }

  void set(const std::string& key, Json v) { obj_[key] = std::move(v); }

  std::string dump() const {
    std::ostringstream out;
    dump_to(out);
    return out.str();
  }

  static Json parse(const std::string& text) {
    size_t pos = 0;
    Json v = parse_value(text, pos);
    skip_ws(text, pos);
    if (pos != text.size()) throw std::runtime_error("trailing JSON data");
    return v;
  }

 private:
  Type type_;
  bool bool_ = false;
  double num_ = 0;
  std::string str_;
  JsonArray arr_;
  JsonObject obj_;

  void dump_to(std::ostringstream& out) const {
    switch (type_) {
      case Type::Null: out << "null"; break;
      case Type::Bool: out << (bool_ ? "true" : "false"); break;
      case Type::Number: {
        if (num_ == static_cast<int64_t>(num_)) {
          out << static_cast<int64_t>(num_);
        } else {
          out << num_;
        }
        break;
      }
      case Type::String: dump_string(out, str_); break;
      case Type::Array: {
        out << '[';
        for (size_t i = 0; i < arr_.size(); ++i) {
          if (i) out << ',';
          arr_[i].dump_to(out);
        }
        out << ']';
        break;
      }
      case Type::Object: {
        out << '{';
        bool first = true;
        for (const auto& kv : obj_) {
          if (!first) out << ',';
          first = false;
          dump_string(out, kv.first);
          out << ':';
          kv.second.dump_to(out);
        }
        out << '}';
        break;
      }
    }
  }

  static void dump_string(std::ostringstream& out, const std::string& s) {
    out << '"';
    for (unsigned char c : s) {
      switch (c) {
        case '"': out << "\\\""; break;
        case '\\': out << "\\\\"; break;
        case '\n': out << "\\n"; break;
        case '\r': out << "\\r"; break;
        case '\t': out << "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            snprintf(buf, sizeof buf, "\\u%04x", c);
            out << buf;
          } else {
            out << c;
          }
      }
    }
    out << '"';
  }

  static void skip_ws(const std::string& t, size_t& pos) {
    while (pos < t.size() &&
           (t[pos] == ' ' || t[pos] == '\t' || t[pos] == '\n' || t[pos] == '\r'))
      ++pos;
  }

  static Json parse_value(const std::string& t, size_t& pos) {
    skip_ws(t, pos);
    if (pos >= t.size()) throw std::runtime_error("unexpected end of JSON");
    char c = t[pos];
    if (c == '{') return parse_object(t, pos);
    if (c == '[') return parse_array(t, pos);
    if (c == '"') return Json(parse_string(t, pos));
    if (t.compare(pos, 4, "true") == 0) { pos += 4; return Json(true); }
    if (t.compare(pos, 5, "false") == 0) { pos += 5; return Json(false); }
    if (t.compare(pos, 4, "null") == 0) { pos += 4; return Json(); }
    return parse_number(t, pos);
  }

  static Json parse_object(const std::string& t, size_t& pos) {
    JsonObject obj;
    ++pos;  // '{'
    skip_ws(t, pos);
    if (pos < t.size() && t[pos] == '}') { ++pos; return Json(std::move(obj)); }
    while (true) {
      skip_ws(t, pos);
      if (pos >= t.size() || t[pos] != '"')
        throw std::runtime_error("expected object key");
      std::string key = parse_string(t, pos);
      skip_ws(t, pos);
      if (pos >= t.size() || t[pos] != ':')
        throw std::runtime_error("expected ':'");
      ++pos;
      obj[key] = parse_value(t, pos);
      skip_ws(t, pos);
      if (pos < t.size() && t[pos] == ',') { ++pos; continue; }
      if (pos < t.size() && t[pos] == '}') { ++pos; break; }
      throw std::runtime_error("expected ',' or '}'");
    }
    return Json(std::move(obj));
  }

  static Json parse_array(const std::string& t, size_t& pos) {
    JsonArray arr;
    ++pos;  // '['
    skip_ws(t, pos);
    if (pos < t.size() && t[pos] == ']') { ++pos; return Json(std::move(arr)); }
    while (true) {
      arr.push_back(parse_value(t, pos));
      skip_ws(t, pos);
      if (pos < t.size() && t[pos] == ',') { ++pos; continue; }
      if (pos < t.size() && t[pos] == ']') { ++pos; break; }
      throw std::runtime_error("expected ',' or ']'");
    }
    return Json(std::move(arr));
  }

  static std::string parse_string(const std::string& t, size_t& pos) {
    ++pos;  // '"'
    std::string out;
    while (pos < t.size() && t[pos] != '"') {
      char c = t[pos];
      if (c == '\\') {
        ++pos;
        if (pos >= t.size()) throw std::runtime_error("bad escape");
        char e = t[pos];
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (pos + 4 >= t.size()) throw std::runtime_error("bad \\u escape");
            unsigned code = std::stoul(t.substr(pos + 1, 4), nullptr, 16);
            pos += 4;
            // UTF-8 encode (surrogate pairs folded to replacement — the
            // plugin protocol carries ASCII identifiers)
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: throw std::runtime_error("bad escape");
        }
        ++pos;
      } else {
        out += c;
        ++pos;
      }
    }
    if (pos >= t.size()) throw std::runtime_error("unterminated string");
    ++pos;  // closing '"'
    return out;
  }

  static Json parse_number(const std::string& t, size_t& pos) {
    size_t start = pos;
    if (pos < t.size() && (t[pos] == '-' || t[pos] == '+')) ++pos;
    while (pos < t.size() &&
           (isdigit(static_cast<unsigned char>(t[pos])) || t[pos] == '.' ||
            t[pos] == 'e' || t[pos] == 'E' || t[pos] == '-' || t[pos] == '+'))
      ++pos;
    if (pos == start) throw std::runtime_error("invalid JSON value");
    return Json(std::stod(t.substr(start, pos - start)));
  }
};

}  // namespace ktpu
